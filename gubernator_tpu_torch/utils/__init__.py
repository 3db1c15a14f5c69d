"""Host utilities: the freezable clock and Gregorian calendar math."""
