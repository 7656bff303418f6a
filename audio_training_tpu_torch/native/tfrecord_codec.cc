// Native TFRecord framing codec: crc32c (slice-by-8) + record split/frame.
//
// The reference delegates TFRecord IO to TensorFlow's C++ kernels
// (audiowriter.py via tf.io.TFRecordWriter, tfdataset.py via
// TFRecordDataset).  This standalone codec provides the same wire format
// (uint64 LE length | masked crc32c(length) | payload | masked crc32c(payload))
// without a TF dependency; gzip inflate/deflate stays in Python's zlib (also
// C).  Exposed through ctypes — see audio_training_tpu_torch/data/_native.py.
//
// Build: make -C audio_training_tpu_torch/native  (writes build/native/libtfrecord_codec.so)

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

uint32_t crc_table[8][256];
bool table_init = false;

void init_tables() {
  if (table_init) return;
  const uint32_t poly = 0x82f63b78u;  // CRC-32C (Castagnoli), reflected
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = i;
    for (int k = 0; k < 8; k++)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    crc_table[0][i] = crc;
  }
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t crc = crc_table[0][i];
    for (int t = 1; t < 8; t++) {
      crc = (crc >> 8) ^ crc_table[0][crc & 0xff];
      crc_table[t][i] = crc;
    }
  }
  table_init = true;
}

uint32_t crc32c_impl(uint32_t crc, const uint8_t* buf, size_t len) {
  init_tables();
  crc = ~crc;
  // slice-by-8
  while (len >= 8) {
    uint64_t word;
    memcpy(&word, buf, 8);
    word ^= crc;
    crc = crc_table[7][word & 0xff] ^ crc_table[6][(word >> 8) & 0xff] ^
          crc_table[5][(word >> 16) & 0xff] ^ crc_table[4][(word >> 24) & 0xff] ^
          crc_table[3][(word >> 32) & 0xff] ^ crc_table[2][(word >> 40) & 0xff] ^
          crc_table[1][(word >> 48) & 0xff] ^ crc_table[0][(word >> 56) & 0xff];
    buf += 8;
    len -= 8;
  }
  while (len--) crc = (crc >> 8) ^ crc_table[0][(crc ^ *buf++) & 0xff];
  return ~crc;
}

const uint32_t kMaskDelta = 0xa282ead8u;

uint32_t masked_crc(const uint8_t* buf, size_t len) {
  uint32_t crc = crc32c_impl(0, buf, len);
  return ((crc >> 15) | (crc << 17)) + kMaskDelta;
}

void put_u32(uint8_t* p, uint32_t v) { memcpy(p, &v, 4); }
void put_u64(uint8_t* p, uint64_t v) { memcpy(p, &v, 8); }
uint32_t get_u32(const uint8_t* p) { uint32_t v; memcpy(&v, p, 4); return v; }
uint64_t get_u64(const uint8_t* p) { uint64_t v; memcpy(&v, p, 8); return v; }

}  // namespace

extern "C" {

uint32_t att_crc32c(const uint8_t* buf, size_t len) {
  return crc32c_impl(0, buf, len);
}

uint32_t att_masked_crc(const uint8_t* buf, size_t len) {
  return masked_crc(buf, len);
}

// Split a decompressed TFRecord stream into (offset, length) pairs of record
// payloads.  Returns the number of records, or a negative error:
//   -1 truncated header/payload, -2 length-crc mismatch, -3 data-crc mismatch.
// Call with offsets == nullptr to just count records.
int64_t att_split_records(const uint8_t* buf, uint64_t n,
                          uint64_t* offsets, uint64_t* lengths,
                          uint64_t max_records, int verify_crc) {
  uint64_t pos = 0;
  int64_t count = 0;
  while (pos < n) {
    if (pos + 12 > n) return -1;
    uint64_t len = get_u64(buf + pos);
    uint32_t len_crc = get_u32(buf + pos + 8);
    if (verify_crc && masked_crc(buf + pos, 8) != len_crc) return -2;
    uint64_t data_off = pos + 12;
    if (data_off + len + 4 > n) return -1;
    if (verify_crc &&
        masked_crc(buf + data_off, len) != get_u32(buf + data_off + len))
      return -3;
    if (offsets != nullptr) {
      if ((uint64_t)count >= max_records) return count;
      offsets[count] = data_off;
      lengths[count] = len;
    }
    count++;
    pos = data_off + len + 4;
  }
  return count;
}

// Frame one record: writes 8+4 header, payload, 4 footer into out
// (size must be >= len + 16).  Returns total bytes written.
uint64_t att_frame_record(const uint8_t* data, uint64_t len, uint8_t* out) {
  put_u64(out, len);
  put_u32(out + 8, masked_crc(out, 8));
  memcpy(out + 12, data, len);
  put_u32(out + 12 + len, masked_crc(data, len));
  return len + 16;
}

}  // extern "C"
