// Native host paths of the PyTorch port: the TIFF codecs and the host
// mosaic blend, called through ctypes from srbh_tpu_torch/native/__init__.py.
//
// The port's copy of srbh_tpu/native/tiffcodec.cpp, holding the four
// functions that Python calls (the zlib and predictor helpers there are
// called by nothing):
//   * PackBits decode/encode (TIFF compression 32773)
//   * LZW decode (TIFF compression 5)
//   * batched mosaic blend: int64 canvas += uint16 tiles at positions
//
// Plain C ABI. Build: g++ -O3 -shared -fPIC tiffcodec.cpp -o libtiffcodec.so
// The Python wrappers check sizes, dtypes and the tiles' bounds before they
// pass a pointer here.

#include <cstdint>
#include <cstring>

extern "C" {

// PackBits decode. Returns bytes written, or -1 when a run header ends the
// stream without its byte.
long packbits_decode(const uint8_t* src, long src_len, uint8_t* dst,
                     long dst_len) {
  long i = 0, o = 0;
  while (i < src_len && o < dst_len) {
    int8_t h = static_cast<int8_t>(src[i++]);
    if (h >= 0) {
      long n = h + 1;
      if (i + n > src_len) n = src_len - i;
      if (o + n > dst_len) n = dst_len - o;
      std::memcpy(dst + o, src + i, n);
      i += n;
      o += n;
    } else if (h != -128) {
      long n = 1 - h;
      if (i >= src_len) return -1;
      if (o + n > dst_len) n = dst_len - o;
      std::memset(dst + o, src[i], n);
      i += 1;
      o += n;
    }
  }
  return o;
}

// PackBits encode (literal/run hybrid, same policy as the Python encoder).
// Returns bytes written (dst must hold >= src_len + src_len/127 + 1).
long packbits_encode(const uint8_t* src, long n, uint8_t* dst) {
  long i = 0, o = 0;
  while (i < n) {
    long run = 1;
    while (i + run < n && run < 127 && src[i + run] == src[i]) run++;
    if (run >= 2) {
      dst[o++] = static_cast<uint8_t>(257 - run);
      dst[o++] = src[i];
      i += run;
    } else {
      long j = i + 1;
      while (j < n && j - i < 128) {
        if (j + 2 < n && src[j] == src[j + 1] && src[j] == src[j + 2]) break;
        j++;
      }
      dst[o++] = static_cast<uint8_t>(j - i - 1);
      std::memcpy(dst + o, src + i, j - i);
      o += j - i;
      i = j;
    }
  }
  return o;
}

// TIFF-flavour LZW decode (MSB-first codes, early change), as the Python
// version in srbh_tpu_torch/data/tiff.py:_lzw_decode. Returns bytes
// written, or -1 on malformed input.
long lzw_decode(const uint8_t* src, long src_len, uint8_t* dst,
                long dst_len) {
  constexpr int CLEAR = 256, EOI = 257, MAXCODES = 4096;
  static_assert(MAXCODES == 1 << 12, "12-bit codes");
  uint16_t prefix[MAXCODES];
  uint8_t suffix[MAXCODES];
  uint8_t firstb[MAXCODES];
  for (int i = 0; i < 256; ++i) {
    suffix[i] = firstb[i] = static_cast<uint8_t>(i);
    prefix[i] = 0xFFFF;
  }
  int next = 258, codesize = 9, prev = -1;
  uint32_t bitbuf = 0;
  int bitcnt = 0;
  long o = 0;
  uint8_t stack[MAXCODES];

  for (long i = 0; i < src_len; ++i) {
    bitbuf = (bitbuf << 8) | src[i];
    bitcnt += 8;
    while (bitcnt >= codesize) {
      int code = (bitbuf >> (bitcnt - codesize)) & ((1 << codesize) - 1);
      bitcnt -= codesize;
      if (code == CLEAR) {
        next = 258;
        codesize = 9;
        prev = -1;
        continue;
      }
      if (code == EOI) return o;
      int entry_first;
      long sp = 0;
      if (prev < 0) {
        if (code > 255) return -1;  // first code must be a literal
        entry_first = code;
        stack[sp++] = static_cast<uint8_t>(code);
      } else if (code < next && code != EOI && code != CLEAR) {
        // known code: emit its string, add (prev + first(code))
        entry_first = firstb[code];
        for (int c = code; c != -1;) {
          stack[sp++] = suffix[c];
          c = (c < 256) ? -1 : (prefix[c] == 0xFFFF ? -1 : prefix[c]);
          if (sp >= MAXCODES) return -1;
        }
        if (next < MAXCODES) {
          prefix[next] = static_cast<uint16_t>(prev);
          suffix[next] = static_cast<uint8_t>(entry_first);
          firstb[next] = firstb[prev];
          next++;
        }
      } else if (code == next) {
        // KwKwK case: emit prev + first(prev)
        entry_first = firstb[prev];
        stack[sp++] = static_cast<uint8_t>(firstb[prev]);
        for (int c = prev; c != -1;) {
          stack[sp++] = suffix[c];
          c = (c < 256) ? -1 : (prefix[c] == 0xFFFF ? -1 : prefix[c]);
          if (sp >= MAXCODES) return -1;
        }
        if (next < MAXCODES) {
          prefix[next] = static_cast<uint16_t>(prev);
          suffix[next] = static_cast<uint8_t>(firstb[prev]);
          firstb[next] = firstb[prev];
          next++;
        }
      } else {
        return -1;  // code beyond table
      }
      // pop the reversed string
      while (sp > 0 && o < dst_len) dst[o++] = stack[--sp];
      if (o >= dst_len) return o;
      prev = code;
      if (next >= (1 << codesize) - 1 && codesize < 12) codesize++;
    }
  }
  return o;
}

// Mosaic blend: for each tile i, add height[i] (T x T) and build[i]
// (T x T x C) into the int64 canvases at (pos[i*4+0], pos[i*4+1]) * upscale,
// clipped to (pos[i*4+2], pos[i*4+3]) * upscale, and bump the hit counter.
// height_canvas: H x W; build_canvas: C x H x W; weight: H x W (uint16).
// Every tile lies inside the canvas (the caller checks).
void blend_tiles(int64_t* height_canvas, int64_t* build_canvas,
                 uint16_t* weight, long H, long W, long C,
                 const uint16_t* height_tiles, const uint16_t* build_tiles,
                 const int32_t* pos, long n_tiles, long tile, long upscale) {
  const long T = tile * upscale;
  for (long i = 0; i < n_tiles; ++i) {
    long xoff = static_cast<long>(pos[i * 4 + 0]) * upscale;
    long yoff = static_cast<long>(pos[i * 4 + 1]) * upscale;
    long xc = static_cast<long>(pos[i * 4 + 2]) * upscale;
    long yc = static_cast<long>(pos[i * 4 + 3]) * upscale;
    const uint16_t* ht = height_tiles + i * T * T;
    const uint16_t* bt = build_tiles + i * T * T * C;
    for (long y = 0; y < yc; ++y) {
      int64_t* hrow = height_canvas + (yoff + y) * W + xoff;
      const uint16_t* hsrc = ht + y * T;
      for (long x = 0; x < xc; ++x) hrow[x] += hsrc[x];
      uint16_t* wrow = weight + (yoff + y) * W + xoff;
      for (long x = 0; x < xc; ++x) wrow[x] += 1;
      for (long c = 0; c < C; ++c) {
        int64_t* brow = build_canvas + (c * H + yoff + y) * W + xoff;
        const uint16_t* bsrc = bt + (y * T) * C + c;  // HWC tiles
        for (long x = 0; x < xc; ++x) brow[x] += bsrc[x * C];
      }
    }
  }
}

}  // extern "C"
