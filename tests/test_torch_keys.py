"""The port's key hasher against the JAX package's native hasher.

Both are MurmurHash3 x64-128 over the UTF-8 bytes of
`name + "_" + unique_key`; the port builds its own copy of the source
(`gubernator_tpu_torch/csrc/guberhash.cc`). Digests, batch digests and
slot groups must be identical, or snapshots would not move between the
two packages.
"""

import numpy as np
import pytest

from gubernator_tpu import native
from gubernator_tpu_torch.api import keys

KEY_SETS = {
    "ascii": [f"rl_{i}_acct:{i * 7919}" for i in range(40)]
    + ["a_b", "x" * 15 + "_", "y" * 16 + "_z", "z" * 33],
    "utf8": ["名前_ключ", "ünïcödé_🔑", "rl_éèê", "🙂_🙂🙂", "ß" * 9 + "_k"],
    "empty_suffix": ["rl_", "_", "n_", "longer-namespace-name_", ""],
}


@pytest.mark.parametrize("kind", sorted(KEY_SETS))
def test_digest_matches_native(kind):
    assert native.available()
    for k in KEY_SETS[kind]:
        assert keys.key_hash128(k) == native.hash128(k), k


@pytest.mark.parametrize("kind", sorted(KEY_SETS))
@pytest.mark.parametrize("num_groups", [64, 512, 1 << 18])
def test_batch_digest_and_group_match_native(kind, num_groups):
    ks = KEY_SETS[kind]
    hi, lo, grp = keys.key_hash128_batch(ks, num_groups)
    nhi, nlo, ngrp = native.hash128_batch(ks, num_groups)
    assert hi.dtype == np.int64 and lo.dtype == np.int64 and grp.dtype == np.int32
    assert np.array_equal(hi, nhi)
    assert np.array_equal(lo, nlo)
    assert np.array_equal(grp, ngrp)
    for k, h, l, g in zip(ks, hi.tolist(), lo.tolist(), grp.tolist()):
        assert keys.key_hash128(k) == (h, l)
        assert keys.group_of(l, num_groups) == g


def test_batch_rejects_zero_groups():
    with pytest.raises(ValueError):
        keys.key_hash128_batch(["a_b"], 0)
