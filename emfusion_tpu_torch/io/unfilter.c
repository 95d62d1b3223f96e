/* Host-side byte loops of the port's image decoders, plain C (no libpng,
 * no zlib: inflate stays Python's zlib.decompress, which releases the
 * interpreter lock, as a ctypes call does).
 *
 *   emf_png_unfilter      reverses PNG's five row filters (None, Sub, Up,
 *                         Average, Paeth; PNG spec section 9) at any bytes
 *                         per pixel: 1, 2, 3, 4, 6 and 8 for 8- and 16-bit
 *                         gray, gray + alpha, RGB and RGBA;
 *   emf_exr_unpredict     undoes OpenEXR's ZIP predictor (bytes stored as
 *                         deltas + 128) and its split of the even and odd
 *                         bytes into two halves.
 *
 * Built at first use with the host C compiler (io/clib.py) into a
 * shared library under emfusion_tpu_torch/build/.
 */

#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>

static uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return (uint8_t)a;
  return (uint8_t)(pb <= pc ? b : c);
}

/* `raw` holds h rows of 1 + stride bytes, each a filter type and the
 * filtered bytes; `out` gets the h x stride reconstructed bytes. The row
 * above the first is zero. Returns 0, or 1 + the row of a filter type
 * above 4 (then `out` is partly written). */
int emf_png_unfilter(const uint8_t* raw, long h, long stride, int bpp,
                     uint8_t* out) {
  for (long y = 0; y < h; ++y) {
    const uint8_t* f = raw + y * (stride + 1) + 1;
    const int type = f[-1];
    uint8_t* o = out + y * stride;
    const uint8_t* up = y ? o - stride : NULL;
    long x = 0;
    switch (type) {
      case 0:
        for (; x < stride; ++x) o[x] = f[x];
        break;
      case 1:
        for (; x < bpp && x < stride; ++x) o[x] = f[x];
        for (; x < stride; ++x) o[x] = (uint8_t)(f[x] + o[x - bpp]);
        break;
      case 2:
        if (!up)
          for (; x < stride; ++x) o[x] = f[x];
        else
          for (; x < stride; ++x) o[x] = (uint8_t)(f[x] + up[x]);
        break;
      case 3:
        if (!up) {
          for (; x < bpp && x < stride; ++x) o[x] = f[x];
          for (; x < stride; ++x) o[x] = (uint8_t)(f[x] + (o[x - bpp] >> 1));
        } else {
          for (; x < bpp && x < stride; ++x)
            o[x] = (uint8_t)(f[x] + (up[x] >> 1));
          for (; x < stride; ++x)
            o[x] = (uint8_t)(f[x] + ((o[x - bpp] + up[x]) >> 1));
        }
        break;
      case 4:
        if (!up) {  /* Paeth of (a, 0, 0) is a: Sub */
          for (; x < bpp && x < stride; ++x) o[x] = f[x];
          for (; x < stride; ++x) o[x] = (uint8_t)(f[x] + o[x - bpp]);
        } else {
          for (; x < bpp && x < stride; ++x)
            o[x] = (uint8_t)(f[x] + up[x]);
          for (; x < stride; ++x)
            o[x] = (uint8_t)(f[x] + paeth(o[x - bpp], up[x], up[x - bpp]));
        }
        break;
      default:
        return (int)(y + 1);
    }
  }
  return 0;
}

/* `in` holds n predicted bytes; `out` gets the n bytes of the block: the
 * running sum of the deltas (the first byte as it is, then each + its
 * delta - 128, mod 256), its first ceil(n / 2) bytes at the even offsets
 * and the rest at the odd ones. */
void emf_exr_unpredict(const uint8_t* in, long n, uint8_t* out) {
  const long half = (n + 1) / 2;
  uint8_t t = 0;
  for (long i = 0; i < n; ++i) {
    t = i ? (uint8_t)(t + in[i] - 128) : in[0];
    out[i < half ? 2 * i : 2 * (i - half) + 1] = t;
  }
}
