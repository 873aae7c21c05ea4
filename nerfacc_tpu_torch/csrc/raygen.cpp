// Native host-side ray-batch assembly for the data loaders (the port's
// copy of nerfacc_tpu/csrc/raygen.cpp: the same code, built with the same
// flags, so that one seed gives both packages the same batch).
//
// The images stay in host RAM and this library assembles (origins, dirs,
// pixels) batches in one pass -- RNG, pixel composite over the background,
// camera-to-world rotation and normalization -- writing straight into
// caller-provided buffers (page-locked ones in the port's loaders, which
// reach the card in one asynchronous copy per step). OpenMP-parallel
// across the batch.
//
// C ABI only (loaded via ctypes, no pybind11 dependency).

#include <cmath>
#include <cstdint>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// splitmix64: tiny, seedable, statistically solid for sampling work.
inline uint64_t splitmix64(uint64_t &state) {
  uint64_t z = (state += 0x9e3779b97f4a7c15ULL);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
  return z ^ (z >> 31);
}

inline float uniform01(uint64_t &state) {
  return (splitmix64(state) >> 40) * (1.0f / 16777216.0f);
}

}  // namespace

extern "C" {

// Sample `num_rays` random pixels across `n_images` and emit ray batches.
//
//   images:  (n_images, h, w, channels) float32, channels in {3, 4}
//   poses:   (n_images, 3, 4) float32 camera-to-world
//   intrin:  {fx, fy, cx, cy}
//   opengl:  1 = blender convention (x right, y up, z backward)
//            0 = opencv convention (x right, y down, z forward)
//   bkgd:    (3,) background color composited under RGBA images
// Outputs:
//   origins, dirs: (num_rays, 3) float32 (dirs normalized)
//   pixels:        (num_rays, 3) float32
void sample_ray_batch(
    const float *images, int64_t n_images, int64_t h, int64_t w,
    int64_t channels, const float *poses, const float *intrin, int opengl,
    const float *bkgd, uint64_t seed, int64_t num_rays, float *origins,
    float *dirs, float *pixels) {
  const float fx = intrin[0], fy = intrin[1], cx = intrin[2], cy = intrin[3];

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < num_rays; ++i) {
    uint64_t state = seed ^ (0x5851f42d4c957f2dULL * (uint64_t)(i + 1));
    // burn one draw to decorrelate low seeds
    splitmix64(state);
    const int64_t img = (int64_t)(uniform01(state) * n_images) % n_images;
    const int64_t y = (int64_t)(uniform01(state) * h) % h;
    const int64_t x = (int64_t)(uniform01(state) * w) % w;

    const float *px = images + ((img * h + y) * w + x) * channels;
    if (channels == 4) {
      const float a = px[3];
      pixels[i * 3 + 0] = px[0] * a + bkgd[0] * (1.0f - a);
      pixels[i * 3 + 1] = px[1] * a + bkgd[1] * (1.0f - a);
      pixels[i * 3 + 2] = px[2] * a + bkgd[2] * (1.0f - a);
    } else {
      pixels[i * 3 + 0] = px[0];
      pixels[i * 3 + 1] = px[1];
      pixels[i * 3 + 2] = px[2];
    }

    // camera-space direction through the pixel center
    float dx = (x + 0.5f - cx) / fx;
    float dy = (y + 0.5f - cy) / fy;
    float dz;
    if (opengl) {
      dy = -dy;
      dz = -1.0f;
    } else {
      dz = 1.0f;
    }

    const float *P = poses + img * 12;  // row-major (3, 4)
    float wx = P[0] * dx + P[1] * dy + P[2] * dz;
    float wy = P[4] * dx + P[5] * dy + P[6] * dz;
    float wz = P[8] * dx + P[9] * dy + P[10] * dz;
    const float inv_norm = 1.0f / std::sqrt(wx * wx + wy * wy + wz * wz);
    dirs[i * 3 + 0] = wx * inv_norm;
    dirs[i * 3 + 1] = wy * inv_norm;
    dirs[i * 3 + 2] = wz * inv_norm;
    origins[i * 3 + 0] = P[3];
    origins[i * 3 + 1] = P[7];
    origins[i * 3 + 2] = P[11];
  }
}

// Full-image ray generation for one pose (eval path).
void rays_for_pose(
    int64_t h, int64_t w, const float *pose, const float *intrin, int opengl,
    float *origins, float *dirs) {
  const float fx = intrin[0], fy = intrin[1], cx = intrin[2], cy = intrin[3];
  const float *P = pose;

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      float dx = (x + 0.5f - cx) / fx;
      float dy = (y + 0.5f - cy) / fy;
      float dz;
      if (opengl) {
        dy = -dy;
        dz = -1.0f;
      } else {
        dz = 1.0f;
      }
      float wx = P[0] * dx + P[1] * dy + P[2] * dz;
      float wy = P[4] * dx + P[5] * dy + P[6] * dz;
      float wz = P[8] * dx + P[9] * dy + P[10] * dz;
      const float inv_norm = 1.0f / std::sqrt(wx * wx + wy * wy + wz * wz);
      const int64_t i = y * w + x;
      dirs[i * 3 + 0] = wx * inv_norm;
      dirs[i * 3 + 1] = wy * inv_norm;
      dirs[i * 3 + 2] = wz * inv_norm;
      origins[i * 3 + 0] = P[3];
      origins[i * 3 + 1] = P[7];
      origins[i * 3 + 2] = P[11];
    }
  }
}

}  // extern "C"
