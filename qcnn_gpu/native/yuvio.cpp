// Native host-side frame IO + metrics for the restoration engine.
//
// The equivalent of the reference's host C++ layer
// (inference/yuv_data.cpp): bulk Y-plane extraction from YUV420 files,
// double-precision PSNR (the 65025.0-constant formula, yuv_data.cpp:87-97),
// preprocessing (x-128, cnn.cu:449) and residual application
// (clamp(x+res,0,255), cnn.cu:487-506). Python binds via ctypes
// (qcnn_gpu/native/__init__.py); the NumPy implementations in
// data/yuv.py remain the portable fallback and semantic definition.
//
// Build: g++ -O3 -march=native -shared -fPIC yuvio.cpp -o libqcnnio.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

extern "C" {

// Read `frames` Y planes of a YUV420p 8-bit file into out[frames*h*w],
// starting at frame `start`. Returns number of frames read, or -1 on open
// failure. Seeks past UV planes like yuv_data.cpp:36-37.
long long read_y_planes(const char* path, long long height, long long width,
                        long long start, long long frames, uint8_t* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return -1;
  const long long ysz = height * width;
  const long long fsz = ysz * 3 / 2;
  if (start > 0) {
    if (fseeko(fp, start * fsz, SEEK_SET) != 0) {
      fclose(fp);
      return -1;
    }
  }
  long long n = 0;
  for (; n < frames; ++n) {
    size_t got = fread(out + n * ysz, 1, (size_t)ysz, fp);
    if ((long long)got < ysz) break;
    if (fseeko(fp, ysz / 2, SEEK_CUR) != 0) break;
  }
  fclose(fp);
  return n;
}

// Write Y planes with gray (zero) UV (yuv_data.cpp:113-128). Returns 0 ok.
int write_y_as_420(const char* path, const uint8_t* y, long long frames,
                   long long height, long long width) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return -1;
  const long long ysz = height * width;
  const long long uvsz = ysz / 2;
  uint8_t* uv = new uint8_t[uvsz];
  memset(uv, 0, (size_t)uvsz);
  int rc = 0;
  for (long long i = 0; i < frames; ++i) {
    if (fwrite(y + i * ysz, 1, (size_t)ysz, fp) != (size_t)ysz ||
        fwrite(uv, 1, (size_t)uvsz, fp) != (size_t)uvsz) {
      rc = -1;
      break;
    }
  }
  delete[] uv;
  fclose(fp);
  return rc;
}

// Sum of squared error in double precision (yuv_data.cpp:90-94).
double sse_u8(const uint8_t* a, const uint8_t* b, long long n) {
  double sse = 0.0;
  for (long long i = 0; i < n; ++i) {
    double d = (double)a[i] - (double)b[i];
    sse += d * d;
  }
  return sse;
}

// 10*log10(65025/mse); returns +inf (HUGE_VAL) for identical inputs.
double psnr_u8(const uint8_t* a, const uint8_t* b, long long n) {
  double mse = sse_u8(a, b, n) / (double)n;
  if (mse == 0.0) return HUGE_VAL;
  return 10.0 * log10(65025.0 / mse);
}

// ppro: int8 x = (int)u8 - 128 (cnn.cu:449).
void preprocess_u8(const uint8_t* x, int8_t* out, long long n) {
  for (long long i = 0; i < n; ++i) out[i] = (int8_t)((int)x[i] - 128);
}

// rec = clamp(x + res, 0, 255) (cnn.cu:487-506, int16 intermediate).
void apply_residual_u8(const uint8_t* x, const int32_t* res, uint8_t* out,
                       long long n) {
  for (long long i = 0; i < n; ++i) {
    int v = (int)x[i] + res[i];
    out[i] = (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

}  // extern "C"
