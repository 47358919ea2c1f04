// Host-side TFRecord scanner and tf.Example wire parser of the port: a
// copy of the JAX package's dpig_tpu/data/_native/tfrecord_scanner.cc with
// one more entry point, tfr_crc32c, for the record writer.
//
// Indexes record offsets/lengths and validates CRC32C (Castagnoli,
// slicing-by-8) in one pass, so Python can mmap the file and slice records
// zero-copy. Built by g++ on first use (dpig_tpu_torch/kernels/_build.py,
// `load_host`); dpig_tpu_torch/data/native.py binds it with ctypes.
//
// API (extern "C"):
//   int64_t tfr_scan(const char* path, int64_t* offsets, int64_t* lengths,
//                    int64_t capacity, int verify_crc);
//     Returns the number of records (<= capacity filled), or -1 on I/O
//     error, -2 on a malformed/corrupt record. offsets point at record
//     payloads (not headers).
//   int64_t tfr_count(const char* path, int verify_crc);
//   uint32_t tfr_crc32c(const uint8_t* data, int64_t n);  (unmasked)
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

uint32_t kCrcTable[8][256];

bool BuildTables() {
  const uint32_t poly = 0x82F63B78u;  // Castagnoli, reversed
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    kCrcTable[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = kCrcTable[0][i];
    for (int t = 1; t < 8; ++t) {
      crc = kCrcTable[0][crc & 0xFF] ^ (crc >> 8);
      kCrcTable[t][i] = crc;
    }
  }
  return true;
}

// Built once, thread-safely (a function-local static), on first use: the
// loader's worker threads may verify or compute CRCs concurrently.
void InitTables() {
  static const bool built = BuildTables();
  (void)built;
}

uint32_t Crc32c(const uint8_t* data, size_t n) {
  InitTables();
  uint32_t crc = 0xFFFFFFFFu;
  // slicing-by-8
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    memcpy(&lo, data, 4);
    memcpy(&hi, data + 4, 4);
    lo ^= crc;
    crc = kCrcTable[7][lo & 0xFF] ^ kCrcTable[6][(lo >> 8) & 0xFF] ^
          kCrcTable[5][(lo >> 16) & 0xFF] ^ kCrcTable[4][lo >> 24] ^
          kCrcTable[3][hi & 0xFF] ^ kCrcTable[2][(hi >> 8) & 0xFF] ^
          kCrcTable[1][(hi >> 16) & 0xFF] ^ kCrcTable[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n--) crc = kCrcTable[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

uint32_t MaskedCrc(const uint8_t* data, size_t n) {
  uint32_t crc = Crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

}  // namespace

extern "C" {

int64_t tfr_scan(const char* path, int64_t* offsets, int64_t* lengths,
                 int64_t capacity, int verify_crc) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // The file's size bounds every record: without it, a truncated tail
  // record would pass the fseek below and be indexed past the end.
  if (fseek(f, 0, SEEK_END) != 0) { fclose(f); return -1; }
  const int64_t size = ftell(f);
  if (size < 0 || fseek(f, 0, SEEK_SET) != 0) { fclose(f); return -1; }
  int64_t count = 0;
  int64_t pos = 0;
  uint8_t header[12];
  std::vector<uint8_t> buf;
  while (true) {
    size_t got = fread(header, 1, 12, f);
    if (got == 0) break;          // clean EOF
    if (got != 12) { fclose(f); return -2; }
    uint64_t len;
    uint32_t len_crc;
    memcpy(&len, header, 8);
    memcpy(&len_crc, header + 8, 4);
    if (verify_crc && MaskedCrc(header, 8) != len_crc) {
      fclose(f);
      return -2;
    }
    // a body or CRC past the end of the file: a truncated tail record
    if (size - pos < 16 ||
        len > static_cast<uint64_t>(size - pos - 16)) {
      fclose(f);
      return -2;
    }
    if (count < capacity && offsets && lengths) {
      offsets[count] = pos + 12;
      lengths[count] = static_cast<int64_t>(len);
    }
    if (verify_crc) {
      buf.resize(len + 4);
      if (fread(buf.data(), 1, len + 4, f) != len + 4) {
        fclose(f);
        return -2;
      }
      uint32_t data_crc;
      memcpy(&data_crc, buf.data() + len, 4);
      if (MaskedCrc(buf.data(), len) != data_crc) {
        fclose(f);
        return -2;
      }
    } else {
      if (fseek(f, static_cast<long>(len + 4), SEEK_CUR) != 0) {
        fclose(f);
        return -2;
      }
    }
    pos += 12 + static_cast<int64_t>(len) + 4;
    ++count;
  }
  fclose(f);
  return count;
}

int64_t tfr_count(const char* path, int verify_crc) {
  return tfr_scan(path, nullptr, nullptr, 0, verify_crc);
}

uint32_t tfr_crc32c(const uint8_t* data, int64_t n) {
  return Crc32c(data, static_cast<size_t>(n));
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Single-pass tf.Example wire parser (in place of TF's C++ Example-parsing
// kernels; its plain version, step for step, is
// dpig_tpu_torch/data/example.py:parse_example_features_plain).
//
// It decodes every wanted numeric feature straight into caller float32
// buffers (the 8k-element int64 mask lists never become Python objects)
// and returns (offset, length) views for bytes features (JPEG payloads
// stay zero-copy until PIL decodes them).
//
// Wire layout (tensorflow/core/example/example.proto + feature.proto):
//   Example     { Features features = 1; }
//   Features    { map<string, Feature> feature = 1; }   // repeated entry
//   map entry   { string key = 1; Feature value = 2; }
//   Feature     { oneof { BytesList bytes_list = 1;
//                         FloatList float_list = 2;
//                         Int64List int64_list = 3; } }
//   BytesList   { repeated bytes value = 1; }
//   FloatList   { repeated float value = 1 [packed]; }  // or unpacked
//   Int64List   { repeated int64 value = 1 [packed]; }  // or unpacked

namespace {

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t Varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end && shift < 64) {
      uint8_t b = *p++;
      v |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
    ok = false;
    return 0;
  }

  // Returns field number; fills wire type. 0 on end/error.
  uint32_t Tag(uint32_t* wt) {
    if (p >= end) return 0;
    uint64_t tag = Varint();
    if (!ok) return 0;
    *wt = static_cast<uint32_t>(tag & 7);
    return static_cast<uint32_t>(tag >> 3);
  }

  void Skip(uint32_t wt) {
    switch (wt) {
      case 0: Varint(); break;
      case 1: if (end - p < 8) { ok = false; return; }
              p += 8; break;
      case 2: { uint64_t n = Varint();
                if (n > static_cast<uint64_t>(end - p)) { ok = false; return; }
                p += n; break; }
      case 5: if (end - p < 4) { ok = false; return; }
              p += 4; break;
      default: ok = false;
    }
    if (p > end) ok = false;
  }
};

int64_t ZigZagFree(uint64_t v) {  // int64 fields are plain varints
  return static_cast<int64_t>(v);
}

// Decode one Feature submessage into out/caps/count or byte offsets.
void ParseFeature(const uint8_t* base, Cursor c, float* out, int64_t cap,
                  int64_t* count, int32_t* type, int64_t* boff,
                  int64_t* blen) {
  uint32_t wt;
  while (uint32_t field = c.Tag(&wt)) {
    if (!c.ok) return;
    if (wt != 2) { c.Skip(wt); continue; }
    uint64_t n = c.Varint();
    if (!c.ok || n > static_cast<uint64_t>(c.end - c.p)) return;
    Cursor list{c.p, c.p + n};
    c.p += n;
    if (field == 1) {  // BytesList
      *type = 1;
      uint32_t lwt;
      while (uint32_t lf = list.Tag(&lwt)) {
        if (lf == 1 && lwt == 2) {
          uint64_t bn = list.Varint();
          if (!list.ok || bn > static_cast<uint64_t>(list.end - list.p)) return;
          if (*count == 0) {  // first element only (schema stores one)
            *boff = list.p - base;
            *blen = static_cast<int64_t>(bn);
          }
          ++*count;
          list.p += bn;
        } else {
          list.Skip(lwt);
          if (!list.ok) return;
        }
      }
    } else if (field == 2) {  // FloatList
      *type = 2;
      uint32_t lwt;
      while (uint32_t lf = list.Tag(&lwt)) {
        if (lf != 1) { list.Skip(lwt); continue; }
        if (lwt == 2) {  // packed
          uint64_t bn = list.Varint();
          if (!list.ok || bn > static_cast<uint64_t>(list.end - list.p)) return;
          int64_t m = static_cast<int64_t>(bn / 4);
          for (int64_t i = 0; i < m; ++i) {
            float f;
            memcpy(&f, list.p + 4 * i, 4);
            if (out && *count < cap) out[*count] = f;
            ++*count;
          }
          list.p += bn;
        } else if (lwt == 5) {  // unpacked
          float f;
          if (4 > list.end - list.p) return;
          memcpy(&f, list.p, 4);
          list.p += 4;
          if (out && *count < cap) out[*count] = f;
          ++*count;
        } else {
          list.Skip(lwt);
          if (!list.ok) return;
        }
      }
    } else if (field == 3) {  // Int64List
      *type = 3;
      uint32_t lwt;
      while (uint32_t lf = list.Tag(&lwt)) {
        if (lf != 1) { list.Skip(lwt); continue; }
        if (lwt == 2) {  // packed varints
          uint64_t bn = list.Varint();
          if (!list.ok || bn > static_cast<uint64_t>(list.end - list.p)) return;
          Cursor packed{list.p, list.p + bn};
          list.p += bn;
          while (packed.p < packed.end) {
            int64_t v = ZigZagFree(packed.Varint());
            if (!packed.ok) return;
            if (out && *count < cap) out[*count] = static_cast<float>(v);
            ++*count;
          }
        } else if (lwt == 0) {  // unpacked varint
          int64_t v = ZigZagFree(list.Varint());
          if (!list.ok) return;
          if (out && *count < cap) out[*count] = static_cast<float>(v);
          ++*count;
        } else {
          list.Skip(lwt);
          if (!list.ok) return;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Parse `n_wanted` features out of one serialized Example in one pass.
// names: null-separated feature names. For wanted slot i:
//   fbufs[i] (may be null) gets numeric values decoded to float32, up to
//   caps[i]; counts[i] = total element count (may exceed caps[i]);
//   types[i] = 1 bytes / 2 float / 3 int64 / 0 absent;
//   boffs[i]/blens[i] = offset+length (into `rec`) of the FIRST bytes
//   element for bytes features.
// Returns number of wanted features found, or -1 on malformed input.
int64_t tfr_parse(const uint8_t* rec, int64_t len, const char* names,
                  int64_t n_wanted, float** fbufs, const int64_t* caps,
                  int64_t* counts, int32_t* types, int64_t* boffs,
                  int64_t* blens) {
  // Pre-split names.
  std::vector<const char*> keys(n_wanted);
  std::vector<size_t> klen(n_wanted);
  {
    const char* q = names;
    for (int64_t i = 0; i < n_wanted; ++i) {
      keys[i] = q;
      klen[i] = strlen(q);
      q += klen[i] + 1;
      counts[i] = 0;
      types[i] = 0;
      boffs[i] = -1;
      blens[i] = 0;
    }
  }
  int64_t found = 0;
  std::vector<uint8_t> seen(n_wanted, 0);
  Cursor ex{rec, rec + len};
  uint32_t wt;
  while (uint32_t field = ex.Tag(&wt)) {
    if (!ex.ok) return -1;
    if (field != 1 || wt != 2) { ex.Skip(wt); continue; }
    uint64_t flen = ex.Varint();
    if (!ex.ok || flen > static_cast<uint64_t>(ex.end - ex.p)) return -1;
    Cursor feats{ex.p, ex.p + flen};
    ex.p += flen;
    uint32_t fwt;
    while (uint32_t ffield = feats.Tag(&fwt)) {
      if (!feats.ok) return -1;
      if (ffield != 1 || fwt != 2) { feats.Skip(fwt); continue; }
      uint64_t elen = feats.Varint();
      if (!feats.ok || elen > static_cast<uint64_t>(feats.end - feats.p)) return -1;
      Cursor entry{feats.p, feats.p + elen};
      feats.p += elen;
      // map entry: key (1), value (2)
      const uint8_t* key_p = nullptr;
      uint64_t key_n = 0;
      const uint8_t* val_p = nullptr;
      uint64_t val_n = 0;
      uint32_t ewt;
      while (uint32_t ef = entry.Tag(&ewt)) {
        if (!entry.ok) return -1;
        if (ewt != 2) { entry.Skip(ewt); continue; }
        uint64_t n = entry.Varint();
        if (!entry.ok || n > static_cast<uint64_t>(entry.end - entry.p)) return -1;
        if (ef == 1) { key_p = entry.p; key_n = n; }
        if (ef == 2) { val_p = entry.p; val_n = n; }
        entry.p += n;
      }
      if (!key_p || !val_p) continue;
      for (int64_t i = 0; i < n_wanted; ++i) {
        if (key_n == klen[i] && memcmp(key_p, keys[i], key_n) == 0) {
          if (seen[i]) {
            // proto3 map semantics: a duplicate map-entry key replaces the
            // earlier value (last-entry-wins), so reset this slot before
            // re-parsing instead of accumulating across entries.
            counts[i] = 0;
            types[i] = 0;
            boffs[i] = -1;
            blens[i] = 0;
          } else {
            seen[i] = 1;
            ++found;
          }
          ParseFeature(rec, Cursor{val_p, val_p + val_n}, fbufs[i], caps[i],
                       &counts[i], &types[i], &boffs[i], &blens[i]);
          break;
        }
      }
    }
  }
  return ex.ok ? found : -1;
}

}  // extern "C"
