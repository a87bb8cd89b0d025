// Native snapshot-series loader for DESMO-TPU.
//
// The reference loads ~1000 VTK files per run through the VTK C++ library's
// Python bindings, one file at a time on the Python side
// (DESMO/cylinder_flow/DESMO-Cylinder.py:39-85). This loader reads a whole
// snapshot series in parallel (one worker thread per hardware thread), each
// worker parsing its file's header, decoding the named data array, and
// writing it directly into its column of the preallocated (n, m) float32
// snapshot matrix — no Python-side per-file overhead, no intermediate copies.
//
// Supported formats (the subset the reference datasets use):
//   * XML .vtu with format="appended" encoding="raw" DataArrays
//     (Float32/Float64, optional vtkZLibDataCompressor block compression,
//     UInt32 or UInt64 headers, little-endian)
//   * legacy .vtk BINARY (big-endian) VECTORS/SCALARS in POINT_DATA/CELL_DATA
//
// Anything else falls back to the pure-Python reader (desmo_tpu/io/vtk.py),
// which is the behavioral reference this code is tested against.
//
// Build: g++ -O3 -shared -fPIC -std=c++17 snapshot_loader.cpp -lz -lpthread
// ABI: plain C functions, driven from Python via ctypes (no pybind11).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct Error {
  std::string message;
};

std::string g_last_error;  // per-process; set under failure before returning

std::vector<char> read_file(const std::string &path) {
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) throw Error{"cannot open " + path};
  std::streamsize size = f.tellg();
  f.seekg(0);
  std::vector<char> buf(static_cast<size_t>(size));
  if (!f.read(buf.data(), size)) throw Error{"short read on " + path};
  return buf;
}

// --- tiny helpers over the raw file text ------------------------------------

size_t find_or_throw(const std::string &hay, const std::string &needle,
                     size_t from, const std::string &what) {
  size_t pos = hay.find(needle, from);
  if (pos == std::string::npos) throw Error{"missing " + what};
  return pos;
}

// value of attribute `key="..."` inside the tag starting at `tag_pos`
std::string attr(const std::string &text, size_t tag_pos, size_t tag_end,
                 const std::string &key) {
  std::string pat = key + "=\"";
  size_t pos = text.find(pat, tag_pos);
  if (pos == std::string::npos || pos > tag_end) return "";
  pos += pat.size();
  size_t end = text.find('"', pos);
  return text.substr(pos, end - pos);
}

uint64_t load_uint(const char *p, int size) {
  if (size == 4) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
  }
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

std::vector<char> zlib_inflate(const char *src, size_t src_len,
                               size_t dst_len) {
  std::vector<char> out(dst_len);
  uLongf out_len = dst_len;
  if (uncompress(reinterpret_cast<Bytef *>(out.data()), &out_len,
                 reinterpret_cast<const Bytef *>(src), src_len) != Z_OK)
    throw Error{"zlib inflate failed"};
  out.resize(out_len);
  return out;
}

// --- XML .vtu appended-raw parsing ------------------------------------------

// Locates DataArray Name=`name` under <PointData>/<CellData>, returns the
// decoded payload bytes and the word size (4 or 8).
std::vector<char> decode_vtu(const std::vector<char> &blob,
                             const std::string &name, bool cell_data,
                             int *word_size) {
  std::string text(blob.data(), blob.size());

  bool compressed = text.find("compressor=\"vtkZLibDataCompressor\"") !=
                    std::string::npos;
  int header_size = text.find("header_type=\"UInt64\"") != std::string::npos
                        ? 8
                        : 4;

  const std::string section = cell_data ? "<CellData" : "<PointData";
  size_t sec = find_or_throw(text, section, 0, section);
  size_t sec_end = find_or_throw(
      text, cell_data ? "</CellData>" : "</PointData>", sec, "section end");

  // find the DataArray with our Name inside the section
  size_t cursor = sec;
  size_t tag_pos = std::string::npos, tag_end = 0;
  while (true) {
    size_t cand = text.find("<DataArray", cursor);
    if (cand == std::string::npos || cand > sec_end)
      throw Error{"array '" + name + "' not found"};
    size_t cand_end = find_or_throw(text, ">", cand, "tag close");
    if (attr(text, cand, cand_end, "Name") == name) {
      tag_pos = cand;
      tag_end = cand_end;
      break;
    }
    cursor = cand_end;
  }

  std::string type = attr(text, tag_pos, tag_end, "type");
  if (type == "Float32")
    *word_size = 4;
  else if (type == "Float64")
    *word_size = 8;
  else
    throw Error{"unsupported DataArray type " + type};
  if (attr(text, tag_pos, tag_end, "format") != "appended")
    throw Error{"not an appended DataArray (python fallback handles this)"};
  uint64_t offset = std::stoull(attr(text, tag_pos, tag_end, "offset"));

  size_t app = find_or_throw(text, "<AppendedData", 0, "AppendedData");
  if (attr(text, app, find_or_throw(text, ">", app, "tag"), "encoding") !=
      "raw")
    throw Error{"base64 appended data (python fallback handles this)"};
  size_t start = find_or_throw(text, "_", app, "payload start") + 1 + offset;

  const char *p = blob.data() + start;
  if (!compressed) {
    uint64_t nbytes = load_uint(p, header_size);
    return std::vector<char>(p + header_size, p + header_size + nbytes);
  }
  // header layout: [nblocks, block_size, last_block_size, csize_0..]
  uint64_t nblocks = load_uint(p, header_size);
  uint64_t block_size = load_uint(p + header_size, header_size);
  uint64_t last_size = load_uint(p + 2 * header_size, header_size);
  std::vector<char> out;
  const char *cursor_p = p + (3 + nblocks) * header_size;
  for (uint64_t b = 0; b < nblocks; ++b) {
    uint64_t dst = (b == nblocks - 1 && last_size != 0) ? last_size : block_size;
    uint64_t csize = load_uint(p + (3 + b) * header_size, header_size);
    auto chunk = zlib_inflate(cursor_p, csize, dst);
    out.insert(out.end(), chunk.begin(), chunk.end());
    cursor_p += csize;
  }
  return out;
}

// --- legacy .vtk BINARY parsing ---------------------------------------------

inline float bswap_f32(const char *p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  v = __builtin_bswap32(v);
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}

inline double bswap_f64(const char *p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  v = __builtin_bswap64(v);
  double d;
  std::memcpy(&d, &v, 8);
  return d;
}

// Finds `VECTORS <name> <type>` or `SCALARS <name> <type>` and decodes
// `count` tuples of big-endian floats into out (already sized).
void decode_legacy(const std::vector<char> &blob, const std::string &name,
                   float *out, int64_t expected_values) {
  std::string text(blob.data(), blob.size());
  if (text.find("BINARY") == std::string::npos)
    throw Error{"ASCII legacy file (python fallback handles this)"};
  size_t pos = std::string::npos;
  int ncomp = 0;
  for (const char *kind : {"VECTORS ", "SCALARS "}) {
    size_t cand = text.find(std::string(kind) + name + " ");
    if (cand != std::string::npos) {
      pos = cand;
      ncomp = kind[0] == 'V' ? 3 : 1;
      break;
    }
  }
  if (pos == std::string::npos) throw Error{"array '" + name + "' not found"};
  size_t line_end = find_or_throw(text, "\n", pos, "attribute line end");
  std::string line = text.substr(pos, line_end - pos);
  bool is_double = line.find("double") != std::string::npos;
  size_t data_start = line_end + 1;
  if (ncomp == 1) {  // SCALARS are followed by a LOOKUP_TABLE line
    size_t lt = text.find("LOOKUP_TABLE", data_start);
    if (lt != std::string::npos && lt < data_start + 64)
      data_start = find_or_throw(text, "\n", lt, "lookup end") + 1;
  }
  const char *p = blob.data() + data_start;
  int64_t nvals = expected_values;
  if (is_double) {
    for (int64_t i = 0; i < nvals; ++i) out[i] = (float)bswap_f64(p + 8 * i);
  } else {
    for (int64_t i = 0; i < nvals; ++i) out[i] = bswap_f32(p + 4 * i);
  }
  (void)ncomp;
}

}  // namespace

extern "C" {

// Loads `num_files` snapshots into the caller-allocated column-major-by-
// snapshot matrix `out` of shape (values_per_file, num_files) in C order,
// i.e. out[row * num_files + col]. Paths are a packed array of NUL-terminated
// strings. Returns 0 on success; on failure returns -1 - index_of_bad_file
// and records a message retrievable via snapshot_loader_last_error().
int load_snapshot_series(const char *const *paths, int64_t num_files,
                         const char *array_name, int is_cell_data,
                         int is_legacy, int64_t values_per_file, float *out,
                         int num_threads) {
  std::atomic<int64_t> next(0);
  std::atomic<int64_t> failed(-1);
  std::string err_msg;
  std::mutex err_mu;

  auto worker = [&]() {
    while (true) {
      int64_t i = next.fetch_add(1);
      if (i >= num_files || failed.load() >= 0) return;
      try {
        auto blob = read_file(paths[i]);
        std::vector<float> column(values_per_file);
        if (is_legacy) {
          decode_legacy(blob, array_name, column.data(), values_per_file);
        } else {
          int word = 0;
          auto payload = decode_vtu(blob, array_name, is_cell_data != 0, &word);
          int64_t available = (int64_t)payload.size() / word;
          if (available < values_per_file)
            throw Error{"array shorter than expected in " +
                        std::string(paths[i])};
          if (word == 4) {
            std::memcpy(column.data(), payload.data(),
                        values_per_file * sizeof(float));
          } else {
            const double *src =
                reinterpret_cast<const double *>(payload.data());
            for (int64_t v = 0; v < values_per_file; ++v)
              column[v] = (float)src[v];
          }
        }
        for (int64_t v = 0; v < values_per_file; ++v)
          out[v * num_files + i] = column[v];
      } catch (const Error &e) {
        std::lock_guard<std::mutex> lock(err_mu);
        err_msg = std::string(paths[i]) + ": " + e.message;
        failed.store(i);
        return;
      } catch (...) {
        std::lock_guard<std::mutex> lock(err_mu);
        err_msg = std::string(paths[i]) + ": unknown error";
        failed.store(i);
        return;
      }
    }
  };

  int hw = (int)std::thread::hardware_concurrency();
  int nthreads = num_threads > 0 ? num_threads : (hw > 0 ? hw : 4);
  if ((int64_t)nthreads > num_files) nthreads = (int)num_files;
  std::vector<std::thread> pool;
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
  for (auto &t : pool) t.join();

  if (failed.load() >= 0) {
    g_last_error = err_msg;
    return -1 - (int)failed.load();
  }
  return 0;
}

const char *snapshot_loader_last_error() { return g_last_error.c_str(); }

// Probe how many values the named array holds in one file (so Python can
// allocate the matrix). Returns -1 on failure.
int64_t probe_array_size(const char *path, const char *array_name,
                         int is_cell_data, int is_legacy) {
  try {
    auto blob = read_file(path);
    if (is_legacy) {
      std::string text(blob.data(), blob.size());
      // count from the POINT_DATA/CELL_DATA declaration + VECTORS/SCALARS
      const std::string sect = is_cell_data ? "CELL_DATA" : "POINT_DATA";
      size_t pos = find_or_throw(text, sect, 0, sect);
      int64_t count = std::stoll(text.substr(pos + sect.size() + 1));
      for (const char *kind : {"VECTORS ", "SCALARS "}) {
        if (text.find(std::string(kind) + array_name + " ") !=
            std::string::npos)
          return count * (kind[0] == 'V' ? 3 : 1);
      }
      g_last_error = "array not found in legacy file";
      return -1;
    }
    int word = 0;
    auto payload = decode_vtu(blob, array_name, is_cell_data != 0, &word);
    return (int64_t)payload.size() / word;
  } catch (const Error &e) {
    g_last_error = e.message;
    return -1;
  } catch (...) {
    g_last_error = "unknown error";
    return -1;
  }
}

}  // extern "C"
