/* Undo the row filters of decompressed PNG image data (PNG spec, section 9).
 *
 * Host C, not a CUDA kernel: io/png.py builds it with the system's C
 * compiler into a shared library and calls it through ctypes. Every byte
 * of an Average or Paeth row reads the byte decoded just left of it, so a
 * row is a serial loop; in C it runs at memory speed, where numpy needs one
 * vectorised step per anti-diagonal of the image.
 */
#include <stdint.h>
#include <stdlib.h>

static inline int paeth(int a, int b, int c)
{
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc)
        return a;
    return pb <= pc ? b : c;
}

/* rows: height rows of 1 + stride bytes (the filter type, then the filtered
 * bytes); out: height rows of stride bytes; bpp: bytes per pixel (the
 * distance to the byte "left"). Returns 0, or 1 + the first row whose
 * filter type is not 0-4 (out is then incomplete). */
int png_unfilter(const uint8_t *rows, int64_t height, int64_t stride, int64_t bpp,
                 uint8_t *out)
{
    for (int64_t y = 0; y < height; ++y) {
        const uint8_t *in = rows + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        const uint8_t *up = y ? cur - stride : NULL;
        int64_t x;
        switch (rows[y * (stride + 1)]) {
        case 0:
            for (x = 0; x < stride; ++x)
                cur[x] = in[x];
            break;
        case 1:
            for (x = 0; x < stride; ++x)
                cur[x] = (uint8_t)(in[x] + (x >= bpp ? cur[x - bpp] : 0));
            break;
        case 2:
            for (x = 0; x < stride; ++x)
                cur[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
            break;
        case 3:
            for (x = 0; x < stride; ++x) {
                int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                cur[x] = (uint8_t)(in[x] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (x = 0; x < stride; ++x) {
                int a = x >= bpp ? cur[x - bpp] : 0, b = up ? up[x] : 0;
                int c = (up && x >= bpp) ? up[x - bpp] : 0;
                cur[x] = (uint8_t)(in[x] + paeth(a, b, c));
            }
            break;
        default:
            return (int)(y + 1);
        }
    }
    return 0;
}
