// Columnar protobuf wire path for the serving edge of the PyTorch port.
//
// A copy of the JAX package's native/wirepath.cc, kept in this package
// so the port loads nothing of the JAX package. It parses a
// GetRateLimitsReq directly into column arrays (and builds a
// GetRateLimitsResp directly from column arrays) in one pass over the
// wire bytes, with no per-item Python objects. Field numbers match
// gubernator.proto (requests=1; RateLimitReq name=1 unique_key=2 hits=3
// limit=4 duration=5 algorithm=6 behavior=7 burst=8 metadata=9
// created_at=10; RateLimitResp status=1 limit=2 remaining=3
// reset_time=4 error=5). The owner-metadata builder and the ring
// hashes of the original serve peers and come with them.
//
// Built by gubernator_tpu_torch/ops/_build.py (g++, library "wirepath").

#include <cstdint>
#include <cstring>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  // Length-delimited payload length, bounds-checked against the buffer:
  // an attacker-controlled 64-bit length must never advance the read
  // pointer past (or wrap it around) the end.
  uint64_t len_checked() {
    uint64_t len = varint();
    if (!ok || len > (uint64_t)(end - p)) {
      ok = false;
      return 0;
    }
    return len;
  }

  // Decode a tag and reject what conformant parsers reject: field 0 and
  // field numbers above 2^29-1 (protobuf's FieldDescriptor::kMaxNumber).
  // Without this cap, (uint32_t)(tag >> 3) truncation lets a huge field
  // number alias onto name/unique_key — key material the object path
  // would refuse with DecodeError.
  uint64_t tag_checked() {
    uint64_t tag = varint();
    uint64_t field = tag >> 3;
    if (field == 0 || field > 536870911ULL) ok = false;
    return tag;
  }

  // Skip a field of the given wire type (after its tag).
  void skip(uint32_t wt) {
    switch (wt) {
      case 0:
        varint();
        break;
      case 1:
        p += 8;
        break;
      case 2: {
        uint64_t len = varint();
        if (!ok || len > (uint64_t)(end - p)) {
          ok = false;
          break;
        }
        p += len;
        break;
      }
      case 5:
        p += 4;
        break;
      default:
        ok = false;
    }
    if (p > end) ok = false;
  }
};

// Conformant proto3 parsers reject invalid UTF-8 in `string` fields; the
// object path (protobuf FromString) aborts such requests. Flag them so
// the fast path defers instead of silently serving what the slow path
// would refuse.
bool valid_utf8(const uint8_t* s, int64_t len) {
  int64_t i = 0;
  while (i < len) {
    uint8_t c = s[i];
    int extra;
    uint32_t min_cp;
    if (c < 0x80) {
      i++;
      continue;
    } else if ((c & 0xE0) == 0xC0) {
      extra = 1;
      min_cp = 0x80;
    } else if ((c & 0xF0) == 0xE0) {
      extra = 2;
      min_cp = 0x800;
    } else if ((c & 0xF8) == 0xF0) {
      extra = 3;
      min_cp = 0x10000;
    } else {
      return false;
    }
    if (i + extra >= len) return false;
    uint32_t cp = c & (0x3F >> extra);
    for (int j = 1; j <= extra; j++) {
      if ((s[i + j] & 0xC0) != 0x80) return false;
      cp = (cp << 6) | (s[i + j] & 0x3F);
    }
    if (cp < min_cp || cp > 0x10FFFF || (cp >= 0xD800 && cp <= 0xDFFF))
      return false;
    i += extra + 1;
  }
  return true;
}

inline int64_t zigzag_passthrough(uint64_t v) {
  // proto3 int64 fields use plain varint (two's complement), not zigzag.
  return (int64_t)v;
}

}  // namespace

extern "C" {

// First pass: count RateLimitReq entries and total name+"_"+unique_key
// bytes. Returns count, or -1 on malformed input. key_bytes receives the
// total concatenated key length (incl. the "_" separators).
int guber_count_requests(const uint8_t* buf, int len, int64_t* key_bytes) {
  Reader r{buf, buf + len};
  int n = 0;
  int64_t kb = 0;
  while (r.p < r.end && r.ok) {
    uint64_t tag = r.tag_checked();
    if (!r.ok) return -1;
    uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    if (field == 1 && wt == 2) {
      uint64_t mlen = r.len_checked();
      if (!r.ok) return -1;
      const uint8_t* mend = r.p + mlen;
      Reader m{r.p, mend};
      int64_t name_len = 0, key_len = 0;
      while (m.p < m.end && m.ok) {
        uint64_t t2 = m.tag_checked();
        uint32_t f2 = (uint32_t)(t2 >> 3), w2 = (uint32_t)(t2 & 7);
        if (f2 == 1 && w2 == 2) {
          uint64_t l = m.len_checked();
          name_len = (int64_t)l;
          m.p += l;
        } else if (f2 == 2 && w2 == 2) {
          uint64_t l = m.len_checked();
          key_len = (int64_t)l;
          m.p += l;
        } else {
          m.skip(w2);
        }
      }
      if (!m.ok || m.p > m.end) return -1;
      kb += name_len + 1 + key_len;
      n++;
      r.p = mend;
    } else {
      r.skip(wt);
    }
  }
  if (!r.ok) return -1;
  *key_bytes = kb;
  return n;
}

// Second pass: fill columns. Arrays must hold >= n entries (from
// guber_count_requests); key_data must hold key_bytes bytes and
// key_offsets n+1 entries. slow[i] is set when the item carries metadata
// (field 9) — those need the Python object path. Returns n or -1.
int guber_parse_requests(const uint8_t* buf, int len, int64_t* hits,
                         int64_t* limit, int64_t* duration, int32_t* algo,
                         int64_t* behavior, int64_t* burst,
                         int64_t* created_at, uint8_t* has_created,
                         uint8_t* slow, int64_t* name_lens,
                         uint8_t* key_data, int64_t* key_offsets) {
  Reader r{buf, buf + len};
  int n = 0;
  int64_t kpos = 0;
  key_offsets[0] = 0;
  while (r.p < r.end && r.ok) {
    uint64_t tag = r.tag_checked();
    if (!r.ok) return -1;
    uint32_t field = (uint32_t)(tag >> 3), wt = (uint32_t)(tag & 7);
    if (field == 1 && wt == 2) {
      uint64_t mlen = r.len_checked();
      if (!r.ok) return -1;
      const uint8_t* mend = r.p + mlen;
      Reader m{r.p, mend};
      hits[n] = 0;
      limit[n] = 0;
      duration[n] = 0;
      algo[n] = 0;
      behavior[n] = 0;
      burst[n] = 0;
      created_at[n] = 0;
      has_created[n] = 0;
      slow[n] = 0;
      const uint8_t* name_p = nullptr;
      int64_t name_len = 0;
      const uint8_t* key_p = nullptr;
      int64_t key_len = 0;
      while (m.p < m.end && m.ok) {
        uint64_t t2 = m.tag_checked();
        uint32_t f2 = (uint32_t)(t2 >> 3), w2 = (uint32_t)(t2 & 7);
        switch (f2) {
          case 1:
            if (w2 == 2) {
              uint64_t l = m.len_checked();
              name_p = m.p;
              name_len = (int64_t)l;
              m.p += l;
            } else {
              m.skip(w2);
            }
            break;
          case 2:
            if (w2 == 2) {
              uint64_t l = m.len_checked();
              key_p = m.p;
              key_len = (int64_t)l;
              m.p += l;
            } else {
              m.skip(w2);
            }
            break;
          // Scalar varint fields: consume the value ONLY for wire type 0.
          // A mis-typed field must advance the reader exactly like the
          // count pass's m.skip(w2) does — otherwise the two passes can
          // disagree on where field boundaries are and the second pass
          // writes past the count-sized key buffers (wire-type confusion).
          case 3:
            if (w2 == 0)
              hits[n] = zigzag_passthrough(m.varint());
            else
              m.skip(w2);
            break;
          case 4:
            if (w2 == 0)
              limit[n] = zigzag_passthrough(m.varint());
            else
              m.skip(w2);
            break;
          case 5:
            if (w2 == 0)
              duration[n] = zigzag_passthrough(m.varint());
            else
              m.skip(w2);
            break;
          case 6:
            if (w2 == 0)
              algo[n] = (int32_t)m.varint();
            else
              m.skip(w2);
            break;
          case 7:
            if (w2 == 0)
              behavior[n] = zigzag_passthrough(m.varint());
            else
              m.skip(w2);
            break;
          case 8:
            if (w2 == 0)
              burst[n] = zigzag_passthrough(m.varint());
            else
              m.skip(w2);
            break;
          case 9:
            slow[n] = 1;
            m.skip(w2);
            break;
          case 10:
            if (w2 == 0) {
              created_at[n] = zigzag_passthrough(m.varint());
              has_created[n] = 1;
            } else {
              m.skip(w2);
            }
            break;
          default:
            m.skip(w2);
        }
      }
      if (!m.ok || m.p > m.end) return -1;
      if ((name_p && !valid_utf8(name_p, name_len)) ||
          (key_p && !valid_utf8(key_p, key_len)))
        slow[n] = 1;
      name_lens[n] = name_len;
      if (name_p) {
        memcpy(key_data + kpos, name_p, name_len);
        kpos += name_len;
      }
      key_data[kpos++] = '_';
      if (key_p) {
        memcpy(key_data + kpos, key_p, key_len);
        kpos += key_len;
      }
      key_offsets[n + 1] = kpos;
      n++;
      r.p = mend;
    } else {
      r.skip(wt);
    }
  }
  if (!r.ok) return -1;
  return n;
}

namespace {

inline int varint_size(uint64_t v) {
  int s = 1;
  while (v >= 0x80) {
    v >>= 7;
    s++;
  }
  return s;
}

inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
  while (v >= 0x80) {
    *p++ = (uint8_t)(v | 0x80);
    v >>= 7;
  }
  *p++ = (uint8_t)v;
  return p;
}

}  // namespace

// Build a GetRateLimitsResp from response columns. `out` must have room
// for guber_responses_size(...) bytes. Returns bytes written.
// status==0 fields are omitted (proto3 default), like the generated
// serializer.
int64_t guber_build_responses(int n, const int8_t* status,
                              const int64_t* limit, const int64_t* remaining,
                              const int64_t* reset_time, uint8_t* out) {
  uint8_t* p = out;
  for (int i = 0; i < n; i++) {
    // body size of one RateLimitResp
    int64_t body = 0;
    if (status[i]) body += 1 + varint_size((uint64_t)status[i]);
    if (limit[i]) body += 1 + varint_size((uint64_t)limit[i]);
    if (remaining[i]) body += 1 + varint_size((uint64_t)remaining[i]);
    if (reset_time[i]) body += 1 + varint_size((uint64_t)reset_time[i]);
    *p++ = 0x0A;  // field 1, wire type 2
    p = put_varint(p, (uint64_t)body);
    if (status[i]) {
      *p++ = 0x08;
      p = put_varint(p, (uint64_t)status[i]);
    }
    if (limit[i]) {
      *p++ = 0x10;
      p = put_varint(p, (uint64_t)limit[i]);
    }
    if (remaining[i]) {
      *p++ = 0x18;
      p = put_varint(p, (uint64_t)remaining[i]);
    }
    if (reset_time[i]) {
      *p++ = 0x20;
      p = put_varint(p, (uint64_t)reset_time[i]);
    }
  }
  return p - out;
}

// Worst-case output size for guber_build_responses.
int64_t guber_responses_size(int n) {
  // per item: tag(1) + len(2) + 4 fields x (tag 1 + varint <= 10)
  return (int64_t)n * (3 + 4 * 11);
}

}  // extern "C"
