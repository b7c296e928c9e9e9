// Native hot loops for the huff0 entropy codec (RFC 8878 Huffman).
//
// Table construction and weight-table (de)serialization stay in Python
// (utils/huff0.py of the JAX package — small, cold); these are the per-symbol
// stream loops: the backward bitstream decoder and the forward encoder.

#include <cstddef>
#include <cstdint>
#include <cstring>

#define MINLZ_EXPORT __attribute__((visibility("default")))

extern "C" {

// Decode one huff0 stream (written forward, read backward from the final
// sentinel 1 bit).  dtable: sym[size], nbits[size] with size = 1<<table_log.
// Returns 0 on success, negative on corrupt input.
MINLZ_EXPORT long minlz_huff0_decode_stream(
    const uint8_t* data, size_t len, const uint8_t* sym,
    const uint8_t* nbits, int table_log, uint8_t* out, size_t out_len) {
  if (len == 0) return -1;
  uint8_t last = data[len - 1];
  if (last == 0) return -1;
  // Bit position of the sentinel (total payload bits below it).
  long pos = (long)(len - 1) * 8;
  {
    int hb = 31 - __builtin_clz((uint32_t)last);
    pos += hb;
  }
  // 64-bit sliding container: bits [pos-64, pos) of the stream.
  const uint32_t mask = (1u << table_log) - 1;
  for (size_t i = 0; i < out_len; i++) {
    // peek table_log bits below `pos` (zero-padded past the start).
    long p = pos - table_log;
    uint64_t window;
    long byte0 = p >> 3;
    // Load 8 bytes covering [p, p+table_log); clamp at the start.
    uint64_t v = 0;
    if (byte0 >= 0) {
      size_t navail = len - (size_t)byte0;
      memcpy(&v, data + byte0, navail < 8 ? navail : 8);
      window = v >> (p & 7);
    } else if (p > -64) {
      // p negative: shift zeros in from below.
      memcpy(&v, data, len < 8 ? len : 8);
      window = v << (uint64_t)(-p);
    } else {
      window = 0;  // corrupt stream ran far past the start
    }
    uint32_t idx = (uint32_t)window & mask;
    out[i] = sym[idx];
    pos -= nbits[idx];
  }
  return 0;
}

// Encode one stream: symbols pushed in REVERSE input order, LSB-first bit
// accumulation, closed with a sentinel 1 bit.  vals/lens: code value and
// bit length per byte symbol.  Returns bytes written or negative if the
// output would exceed cap.
MINLZ_EXPORT long minlz_huff0_encode_stream(
    const uint8_t* data, size_t len, const uint16_t* vals,
    const uint8_t* lens, uint8_t* out, size_t cap) {
  uint64_t acc = 0;
  unsigned bits = 0;
  size_t o = 0;
  for (size_t i = len; i-- > 0;) {
    uint8_t s = data[i];
    unsigned n = lens[s];
    if (n == 0) return -1;  // symbol missing from the table
    acc |= (uint64_t)vals[s] << bits;
    bits += n;
    while (bits >= 8) {
      if (o >= cap) return -2;
      out[o++] = (uint8_t)acc;
      acc >>= 8;
      bits -= 8;
    }
  }
  acc |= (uint64_t)1 << bits;
  bits += 1;
  while (bits > 0) {
    if (o >= cap) return -2;
    out[o++] = (uint8_t)acc;
    acc >>= 8;
    bits = bits > 8 ? bits - 8 : 0;
  }
  return (long)o;
}

}  // extern "C"
