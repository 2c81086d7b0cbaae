// Native PLY vertex reader (binary little-endian + ascii), C ABI for ctypes.
//
// Role parity with the reference's tinyply-based loader
// (reference: benchmarks/bm_utils.cpp:24-107): read the x/y/z properties of
// the "vertex" element into doubles. The port's own copy of
// clipper_tpu/native/plyio.cpp (same code and C ABI). Python
// (clipper_tpu_torch/bench/data.py) calls this first and uses its
// pure-Python parser for a layout the reader declines (a count < 0).
//
// Protocol:
//   n = clipper_ply_vertex_count(path)      // < 0: error / unsupported
//   clipper_ply_read_xyz(path, out, n)      // out: n*3 doubles, 0 on success

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Prop {
  std::string name;
  int size = 0;       // bytes (fixed-size properties only)
  char kind = 0;      // 'f' float, 'd' double, 'i' signed int, 'u' unsigned
  bool is_list = false;
};

struct Header {
  bool binary_le = false;
  bool ascii = false;
  long long nvert = -1;
  std::vector<Prop> vprops;       // properties of the vertex element
  bool vertex_first = false;      // vertex is the first element
  long long data_offset = 0;      // file offset where element data starts
};

int prop_size(const std::string& t, char* kind) {
  if (t == "float" || t == "float32") { *kind = 'f'; return 4; }
  if (t == "double" || t == "float64") { *kind = 'd'; return 8; }
  if (t == "char" || t == "int8" || t == "uchar" || t == "uint8") {
    *kind = t[0] == 'u' ? 'u' : 'i';
    return 1;
  }
  if (t == "short" || t == "int16" || t == "ushort" || t == "uint16") {
    *kind = t[0] == 'u' ? 'u' : 'i';
    return 2;
  }
  if (t == "int" || t == "int32" || t == "uint" || t == "uint32") {
    *kind = t[0] == 'u' ? 'u' : 'i';
    return 4;
  }
  *kind = 0;
  return 0;
}

// returns 0 on success; header restricted to what the reader supports:
// vertex must be the FIRST element (true for every common scanner export,
// including the vendored bun10k) so no skipping of unknown elements is
// needed.
int parse_header(FILE* f, Header* h) {
  char line[512];
  if (!fgets(line, sizeof line, f) || strncmp(line, "ply", 3) != 0) return -2;
  std::string cur_elem;
  bool first_elem_seen = false;
  while (fgets(line, sizeof line, f)) {
    std::string s(line);
    while (!s.empty() && (s.back() == '\n' || s.back() == '\r')) s.pop_back();
    if (s.rfind("comment", 0) == 0 || s.empty()) continue;
    if (s.rfind("format", 0) == 0) {
      h->binary_le = s.find("binary_little_endian") != std::string::npos;
      h->ascii = s.find("ascii") != std::string::npos;
      if (!h->binary_le && !h->ascii) return -3;  // big endian unsupported
    } else if (s.rfind("element", 0) == 0) {
      char name[128];
      long long cnt;
      if (sscanf(s.c_str(), "element %127s %lld", name, &cnt) != 2) return -4;
      cur_elem = name;
      if (cur_elem == "vertex") {
        h->nvert = cnt;
        h->vertex_first = !first_elem_seen;
      }
      first_elem_seen = true;
    } else if (s.rfind("property", 0) == 0 && cur_elem == "vertex") {
      Prop p;
      char t1[64], t2[64], nm[128];
      if (sscanf(s.c_str(), "property list %63s %63s %127s", t1, t2, nm) == 3) {
        p.is_list = true;
        p.name = nm;
      } else if (sscanf(s.c_str(), "property %63s %127s", t1, nm) == 2) {
        p.size = prop_size(t1, &p.kind);
        p.name = nm;
        if (p.size == 0) return -5;
      } else {
        return -5;
      }
      h->vprops.push_back(p);
    } else if (s == "end_header") {
      h->data_offset = ftell(f);
      return (h->nvert >= 0 && h->vertex_first) ? 0 : -6;
    }
  }
  return -7;
}

double convert(const unsigned char* p, const Prop& pr) {
  switch (pr.kind) {
    case 'f': { float v; memcpy(&v, p, 4); return v; }
    case 'd': { double v; memcpy(&v, p, 8); return v; }
    case 'i': {
      long long v = 0;
      if (pr.size == 1) { int8_t x; memcpy(&x, p, 1); v = x; }
      if (pr.size == 2) { int16_t x; memcpy(&x, p, 2); v = x; }
      if (pr.size == 4) { int32_t x; memcpy(&x, p, 4); v = x; }
      return static_cast<double>(v);
    }
    case 'u': {
      unsigned long long v = 0;
      if (pr.size == 1) { uint8_t x; memcpy(&x, p, 1); v = x; }
      if (pr.size == 2) { uint16_t x; memcpy(&x, p, 2); v = x; }
      if (pr.size == 4) { uint32_t x; memcpy(&x, p, 4); v = x; }
      return static_cast<double>(v);
    }
  }
  return 0.0;
}

}  // namespace

extern "C" long long clipper_ply_vertex_count(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = parse_header(f, &h);
  fclose(f);
  if (rc != 0) return rc;
  // list properties inside the vertex element make the stride dynamic
  for (const auto& p : h.vprops)
    if (p.is_list) return -8;
  return h.nvert;
}

extern "C" int clipper_ply_read_xyz(const char* path, double* out,
                                    long long n) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  Header h;
  int rc = parse_header(f, &h);
  if (rc != 0 || h.nvert != n) {
    fclose(f);
    return rc ? rc : -9;
  }
  int xi = -1, yi = -1, zi = -1, stride = 0;
  std::vector<int> offs(h.vprops.size(), 0);
  for (size_t i = 0; i < h.vprops.size(); ++i) {
    offs[i] = stride;
    stride += h.vprops[i].size;
    if (h.vprops[i].name == "x") xi = static_cast<int>(i);
    if (h.vprops[i].name == "y") yi = static_cast<int>(i);
    if (h.vprops[i].name == "z") zi = static_cast<int>(i);
  }
  if (xi < 0 || yi < 0 || zi < 0) {
    fclose(f);
    return -10;
  }

  if (h.ascii) {
    // stream doubles; properties are whitespace-separated per vertex row
    std::vector<double> vals(h.vprops.size());
    const size_t np = h.vprops.size();
    for (long long v = 0; v < n; ++v) {
      for (size_t i = 0; i < np; ++i)
        if (fscanf(f, "%lf", &vals[i]) != 1) {
          fclose(f);
          return -11;
        }
      out[v * 3 + 0] = vals[xi];
      out[v * 3 + 1] = vals[yi];
      out[v * 3 + 2] = vals[zi];
    }
    fclose(f);
    return 0;
  }

  std::vector<unsigned char> buf(static_cast<size_t>(stride) * 4096);
  long long done = 0;
  while (done < n) {
    long long take = n - done < 4096 ? n - done : 4096;
    if (fread(buf.data(), stride, take, f) != static_cast<size_t>(take)) {
      fclose(f);
      return -12;
    }
    for (long long v = 0; v < take; ++v) {
      const unsigned char* row = buf.data() + v * stride;
      out[(done + v) * 3 + 0] = convert(row + offs[xi], h.vprops[xi]);
      out[(done + v) * 3 + 1] = convert(row + offs[yi], h.vprops[yi]);
      out[(done + v) * 3 + 2] = convert(row + offs[zi], h.vprops[zi]);
    }
    done += take;
  }
  fclose(f);
  return 0;
}
