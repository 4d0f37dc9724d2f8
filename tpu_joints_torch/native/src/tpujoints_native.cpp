// Native runtime for tpu_joints: fast point-cloud IO + host-side ingestion.
//
// The reference leans on PCL's C++ IO (pcl::io::loadPCDFile at SHOT.cpp:260,
// PCDWriter at crop_pcd.cpp:172) and its V-REP plugin's depth→cloud
// projection (ROS_server.cpp:2112-2176). This library is the TPU framework's
// native equivalent of that host-side runtime: PCD parsing (ascii / binary /
// binary_compressed+LZF), NaN filtering + stride subsampling + sentinel
// padding into the pipeline's fixed-capacity buffers, and the cached-scale
// depth unprojection — the pieces that feed bytes to the device and should
// not burn Python time at serving rate.
//
// Exposed as a C ABI for ctypes (no pybind11 in the image).

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <new>
#include <stdexcept>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// memory
// ---------------------------------------------------------------------------

void tj_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// LZF decompression (PCL binary_compressed payloads)
// ---------------------------------------------------------------------------

static long lzf_decompress(const uint8_t* in, long in_len, uint8_t* out,
                           long out_len) {
  long i = 0, o = 0;
  while (i < in_len && o < out_len) {
    unsigned ctrl = in[i++];
    if (ctrl < 32) {  // literal run of ctrl+1 bytes
      long run = (long)ctrl + 1;
      if (i + run > in_len || o + run > out_len) return -1;
      std::memcpy(out + o, in + i, (size_t)run);
      i += run;
      o += run;
    } else {  // back reference
      long len = (long)(ctrl >> 5);
      if (len == 7) {
        if (i >= in_len) return -1;
        len += in[i++];
      }
      if (i >= in_len) return -1;
      long ref = o - (long)((ctrl & 0x1F) << 8) - (long)in[i++] - 1;
      if (ref < 0 || o + len + 2 > out_len) return -1;
      for (long k = 0; k < len + 2; ++k) out[o++] = out[ref++];
    }
  }
  return o;
}

// ---------------------------------------------------------------------------
// PCD loading
// ---------------------------------------------------------------------------

struct Field {
  std::string name;
  char type;    // F / I / U
  int size;     // bytes
  int count;
  long offset;  // byte offset within a point record
};

// Parses a .pcd file. Returns 0 on success. Outputs are malloc'd; the
// caller owns them (free with tj_free). rgb is 0..1 floats or null when the
// file has no color. n_out = number of points.
//
// Header values are untrusted: field sizes are clamped to {1,2,4,8},
// POINTS/compressed sizes are validated against the actual file size before
// any allocation, and every failure (including bad_alloc) comes back as a
// nonzero rc across the C ABI so the Python fallback can take over.
static int load_pcd_impl(const char* path, float** xyz_out, float** rgb_out,
                         long* n_out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return 1;

  std::vector<Field> fields;
  long npts = 0;
  int mode = -1;  // 0 ascii, 1 binary, 2 binary_compressed
  char line[4096];
  long record_size = 0;

  std::vector<std::string> names;
  std::vector<int> sizes, counts;
  std::vector<char> types;

  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == '#') continue;
    char key[64];
    if (std::sscanf(line, "%63s", key) != 1) continue;
    std::string k(key);
    const char* rest = line + k.size();
    if (k == "FIELDS") {
      char name[64];
      int off = 0, used = 0;
      names.clear();
      while (std::sscanf(rest + off, "%63s%n", name, &used) == 1) {
        names.emplace_back(name);
        off += used;
      }
    } else if (k == "SIZE") {
      int v, off = 0, used = 0;
      sizes.clear();
      while (std::sscanf(rest + off, "%d%n", &v, &used) == 1) {
        sizes.push_back(v);
        off += used;
      }
    } else if (k == "TYPE") {
      char c[8];
      int off = 0, used = 0;
      types.clear();
      while (std::sscanf(rest + off, "%7s%n", c, &used) == 1) {
        types.push_back(c[0]);
        off += used;
      }
    } else if (k == "COUNT") {
      int v, off = 0, used = 0;
      counts.clear();
      while (std::sscanf(rest + off, "%d%n", &v, &used) == 1) {
        counts.push_back(v);
        off += used;
      }
    } else if (k == "POINTS") {
      std::sscanf(rest, "%ld", &npts);
    } else if (k == "DATA") {
      char m[32];
      std::sscanf(rest, "%31s", m);
      std::string ms(m);
      mode = ms == "ascii" ? 0 : ms == "binary" ? 1
             : ms == "binary_compressed" ? 2 : -1;
      break;  // data follows
    }
  }
  if (mode < 0 || npts <= 0 || names.empty() || names.size() != sizes.size() ||
      names.size() != types.size()) {
    std::fclose(f);
    return 2;
  }
  if (counts.size() != names.size()) counts.assign(names.size(), 1);

  long off = 0;
  for (size_t i = 0; i < names.size(); ++i) {
    int sz = sizes[i];
    if ((sz != 1 && sz != 2 && sz != 4 && sz != 8) || counts[i] < 1 ||
        counts[i] > 4096) {
      std::fclose(f);
      return 2;
    }
    Field fd{names[i], types[i], sz, counts[i], off};
    off += (long)sz * counts[i];
    fields.push_back(fd);
  }
  record_size = off;
  if (record_size <= 0) {
    std::fclose(f);
    return 2;
  }

  // Actual payload bytes left in the file — the cap for every
  // header-declared size below.
  long data_start = std::ftell(f);
  std::fseek(f, 0, SEEK_END);
  long file_end = std::ftell(f);
  std::fseek(f, data_start, SEEK_SET);
  long remaining = file_end > data_start ? file_end - data_start : 0;
  if (npts > (long)(((unsigned long)-1 >> 1)) / record_size) {  // overflow
    std::fclose(f);
    return 2;
  }
  if (mode == 1 && record_size * npts > remaining) {
    std::fclose(f);
    return 5;
  }
  if (mode == 0 && npts > remaining) {  // ascii: ≥1 byte per point, minimum
    std::fclose(f);
    return 5;
  }

  int ix = -1, iy = -1, iz = -1, irgb = -1;
  for (size_t i = 0; i < fields.size(); ++i) {
    if (fields[i].name == "x") ix = (int)i;
    else if (fields[i].name == "y") iy = (int)i;
    else if (fields[i].name == "z") iz = (int)i;
    else if (fields[i].name == "rgb" || fields[i].name == "rgba") irgb = (int)i;
  }
  if (ix < 0 || iy < 0 || iz < 0) {
    std::fclose(f);
    return 3;
  }

  float* xyz = (float*)std::malloc(sizeof(float) * 3 * (size_t)npts);
  float* rgb = irgb >= 0 ? (float*)std::malloc(sizeof(float) * 3 * (size_t)npts)
                         : nullptr;
  if (!xyz || (irgb >= 0 && !rgb)) {
    std::free(xyz);
    std::free(rgb);
    std::fclose(f);
    return 4;
  }

  auto unpack_rgb = [&](float packed, float* dst) {
    uint32_t bits;
    std::memcpy(&bits, &packed, 4);
    dst[0] = (float)((bits >> 16) & 0xFF) / 255.0f;
    dst[1] = (float)((bits >> 8) & 0xFF) / 255.0f;
    dst[2] = (float)(bits & 0xFF) / 255.0f;
  };

  int rc = 0;
  if (mode == 0) {  // ascii: stream tokens, keep only the columns we need
    long ncols = 0;
    for (auto& fd : fields) ncols += fd.count;
    long cx = 0, cy = 0, cz = 0, crgb = -1, c = 0;
    for (size_t i = 0; i < fields.size(); ++i) {
      if ((int)i == ix) cx = c;
      if ((int)i == iy) cy = c;
      if ((int)i == iz) cz = c;
      if ((int)i == irgb) crgb = c;
      c += fields[i].count;
    }
    std::vector<double> row((size_t)ncols);
    for (long p = 0; p < npts; ++p) {
      for (long j = 0; j < ncols; ++j) {
        if (std::fscanf(f, "%lf", &row[(size_t)j]) != 1) {
          rc = 5;
          break;
        }
      }
      if (rc) break;
      xyz[3 * p + 0] = (float)row[(size_t)cx];
      xyz[3 * p + 1] = (float)row[(size_t)cy];
      xyz[3 * p + 2] = (float)row[(size_t)cz];
      if (rgb && crgb >= 0) {
        float packed = (float)row[(size_t)crgb];
        unpack_rgb(packed, rgb + 3 * p);
      }
    }
  } else {
    // read the payload
    std::vector<uint8_t> data;
    if (mode == 1) {
      data.resize((size_t)(record_size * npts));
      if ((long)std::fread(data.data(), 1, data.size(), f) <
          (long)data.size())
        rc = 5;
    } else {
      uint32_t comp = 0, uncomp = 0;
      if (std::fread(&comp, 4, 1, f) != 1 || std::fread(&uncomp, 4, 1, f) != 1)
        rc = 5;
      // PCL's writeBinaryCompressed emits exactly record_size·npts
      // uncompressed bytes; anything else is a lying header. The compressed
      // payload cannot exceed what is actually in the file.
      if (!rc && ((long)comp > remaining - 8 ||
                  (long)uncomp != record_size * npts))
        rc = 5;
      if (!rc) {
        std::vector<uint8_t> cbuf((size_t)comp);
        if ((long)std::fread(cbuf.data(), 1, comp, f) < (long)comp) rc = 5;
        data.resize(uncomp);
        if (!rc &&
            lzf_decompress(cbuf.data(), (long)comp, data.data(),
                           (long)uncomp) != (long)uncomp)
          rc = 6;
      }
    }
    if (!rc) {
      auto fetch = [&](const Field& fd, long p) -> float {
        const uint8_t* src;
        if (mode == 1) {
          src = data.data() + (size_t)(p * record_size + fd.offset);
        } else {
          // binary_compressed is SoA: all of field 0, then field 1, ...
          src = data.data() +
                (size_t)(fd.offset * npts + p * fd.size * fd.count);
        }
        if (fd.type == 'F' && fd.size == 4) {
          float v;
          std::memcpy(&v, src, 4);
          return v;
        }
        if (fd.type == 'F' && fd.size == 8) {
          double v;
          std::memcpy(&v, src, 8);
          return (float)v;
        }
        // Integer fields can be 1/2/4/8 bytes (header-controlled): copy into
        // an 8-byte local, never a narrower one.
        if (fd.type == 'U') {
          uint64_t v = 0;
          std::memcpy(&v, src, (size_t)fd.size);
          return (float)v;
        }
        int64_t v = 0;
        std::memcpy(&v, src, (size_t)fd.size);
        if (fd.size < 8) {  // sign-extend from the field's width
          int shift = 64 - 8 * fd.size;
          v = (int64_t)((uint64_t)v << shift) >> shift;
        }
        return (float)v;
      };
      for (long p = 0; p < npts; ++p) {
        xyz[3 * p + 0] = fetch(fields[(size_t)ix], p);
        xyz[3 * p + 1] = fetch(fields[(size_t)iy], p);
        xyz[3 * p + 2] = fetch(fields[(size_t)iz], p);
        if (rgb) unpack_rgb(fetch(fields[(size_t)irgb], p), rgb + 3 * p);
      }
    }
  }
  std::fclose(f);
  if (rc) {
    std::free(xyz);
    std::free(rgb);
    return rc;
  }
  *xyz_out = xyz;
  *rgb_out = rgb;
  *n_out = npts;
  return 0;
}

int tj_load_pcd(const char* path, float** xyz_out, float** rgb_out,
                long* n_out) {
  *xyz_out = nullptr;
  *rgb_out = nullptr;
  *n_out = 0;
  // Nothing may escape the C ABI: a bad_alloc from a hostile header must be
  // an error code, not a process abort, so the ctypes caller can fall back
  // to the pure-Python parser.
  try {
    return load_pcd_impl(path, xyz_out, rgb_out, n_out);
  } catch (const std::bad_alloc&) {
    return 7;
  } catch (...) {
    return 8;
  }
}

// ---------------------------------------------------------------------------
// Ingestion: NaN filter + stride subsample + sentinel padding
// ---------------------------------------------------------------------------

// Compacts finite points of xyz[n,3]; if more than `capacity` remain, takes
// an even stride subsample; pads the rest of out[capacity,3] with `sentinel`
// and fills mask[capacity] (1 valid / 0 pad). Returns the number of valid
// output points. The device-side pipeline consumes out/mask directly.
long tj_ingest(const float* xyz, long n, long capacity, float sentinel,
               float* out, uint8_t* mask) {
  std::vector<long> keep;
  keep.reserve((size_t)n);
  for (long i = 0; i < n; ++i) {
    float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    if (std::isfinite(x) && std::isfinite(y) && std::isfinite(z))
      keep.push_back(i);
  }
  long m = (long)keep.size();
  long take = m < capacity ? m : capacity;
  for (long j = 0; j < take; ++j) {
    // evenly spaced selection (matches the Python server's stride subsample)
    long i = keep[(size_t)(m <= capacity ? j : (j * (m - 1)) / (take - 1 ? take - 1 : 1))];
    out[3 * j] = xyz[3 * i];
    out[3 * j + 1] = xyz[3 * i + 1];
    out[3 * j + 2] = xyz[3 * i + 2];
    mask[j] = 1;
  }
  for (long j = take; j < capacity; ++j) {
    out[3 * j] = out[3 * j + 1] = out[3 * j + 2] = sentinel;
    mask[j] = 0;
  }
  return take;
}

// ---------------------------------------------------------------------------
// Depth → organized cloud (the vendored plugin's projection,
// ROS_server.cpp:2144-2164, with cached per-pixel scales)
// ---------------------------------------------------------------------------

// depth[h*w] row-major; metric unless far > near (then normalized 0..1 in
// [near, far]). Writes xyz[h*w*3]; invalid pixels become NaN.
void tj_depth_to_cloud(const float* depth, long h, long w, float fov_deg,
                       float near, float far, float* xyz) {
  const float tan_half = std::tan(fov_deg * (float)M_PI / 360.0f);
  const float aspect = (float)h / (float)w;
  std::vector<float> xs((size_t)w), ys((size_t)h);
  // x is negated to match the reference camera frame (ROS_server.cpp:2149:
  // x_scale = -(i - resol_x/2)/f); keep in sync with serve/depth.py.
  for (long u = 0; u < w; ++u)
    xs[(size_t)u] = -(2.0f * ((float)u + 0.5f) / (float)w - 1.0f) * tan_half;
  for (long v = 0; v < h; ++v)
    ys[(size_t)v] =
        (2.0f * ((float)v + 0.5f) / (float)h - 1.0f) * tan_half * aspect;
  const bool normalized = far > near;
  const float zmax = normalized ? far * (1.0f - 1e-4f) : 0.0f;
  const float nanv = std::nanf("");
  for (long v = 0; v < h; ++v) {
    for (long u = 0; u < w; ++u) {
      long i = v * w + u;
      float z = depth[i];
      if (normalized) z = near + z * (far - near);
      bool bad = !std::isfinite(z) || z <= 0.0f || (normalized && z >= zmax);
      if (bad) {
        xyz[3 * i] = xyz[3 * i + 1] = xyz[3 * i + 2] = nanv;
      } else {
        xyz[3 * i] = z * xs[(size_t)u];
        xyz[3 * i + 1] = z * ys[(size_t)v];
        xyz[3 * i + 2] = z;
      }
    }
  }
}

int tj_abi_version() { return 1; }

}  // extern "C"
