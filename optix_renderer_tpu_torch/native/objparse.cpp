// Fast OBJ geometry parser (native tier of scene/obj_loader.py).
//
// The reference links tinyobjloader (C++) for its ~1M-triangle scenes
// (src/Model.cpp:130-252, include/tiny_obj_loader.h); the pure-Python
// line loop costs ~25 s at that scale.  This single-file C++17 library
// parses v/vn/vt/f/usemtl/mtllib/o/g records with the same observable
// semantics (fan triangulation, negative-index resolution, material
// persistence across groups) and hands flat buffers to Python over a
// two-pass ctypes ABI: obj_count() sizes everything, obj_parse() fills
// caller-allocated numpy buffers.  MTL parsing / texture IO stay in
// Python (tiny files, reference semantics live there).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Buf {
    const char* p;
    const char* end;
};

inline void skip_ws(Buf& b) {
    while (b.p < b.end && (*b.p == ' ' || *b.p == '\t' || *b.p == '\r')) ++b.p;
}

inline void skip_line(Buf& b) {
    while (b.p < b.end && *b.p != '\n') ++b.p;
    if (b.p < b.end) ++b.p;
}

inline float read_float(Buf& b) {
    char* out;
    float v = strtof(b.p, &out);
    b.p = out;
    return v;
}

inline long read_int(Buf& b) {
    char* out;
    long v = strtol(b.p, &out, 10);
    b.p = out;
    return v;
}

std::string read_file(const char* path) {
    FILE* f = fopen(path, "rb");
    if (!f) return {};
    fseek(f, 0, SEEK_END);
    long n = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::string s(static_cast<size_t>(n), '\0');
    size_t got = fread(s.data(), 1, static_cast<size_t>(n), f);
    fclose(f);
    s.resize(got);
    return s;
}

struct Corner {
    int vi, ti, ni;
};

// one full parse; when fill==false only counts are produced
struct Result {
    int64_t n_pos = 0, n_nrm = 0, n_tex = 0, n_tri = 0;
    std::string usemtl_names;  // '\n'-joined, first-use order
    std::string mtllibs;       // '\n'-joined
};

int parse(const char* path, bool fill, Result& r,
          float* pos, float* nrm, float* tex,
          int32_t* tri_idx, int32_t* tri_mtl, int32_t* tri_shape) {
    std::string data = read_file(path);
    if (data.empty()) return -1;
    Buf b{data.data(), data.data() + data.size()};

    std::vector<std::string> mtl_order;
    int cur_mtl = -1;
    int cur_shape = 0;
    bool shape_used = false;
    int64_t np = 0, nn = 0, nt = 0, ntri = 0;
    std::vector<Corner> corners;
    corners.reserve(8);

    while (b.p < b.end) {
        skip_ws(b);
        if (b.p >= b.end) break;
        const char* tok = b.p;
        if (tok[0] == 'v' && b.p + 1 < b.end && (tok[1] == ' ' || tok[1] == '\t')) {
            b.p += 1;
            float x = read_float(b), y = read_float(b), z = read_float(b);
            if (fill) { pos[np * 3] = x; pos[np * 3 + 1] = y; pos[np * 3 + 2] = z; }
            ++np;
            skip_line(b);
        } else if (tok[0] == 'v' && tok[1] == 'n') {
            b.p += 2;
            float x = read_float(b), y = read_float(b), z = read_float(b);
            if (fill) { nrm[nn * 3] = x; nrm[nn * 3 + 1] = y; nrm[nn * 3 + 2] = z; }
            ++nn;
            skip_line(b);
        } else if (tok[0] == 'v' && tok[1] == 't') {
            b.p += 2;
            float u = read_float(b), v = read_float(b);
            if (fill) { tex[nt * 2] = u; tex[nt * 2 + 1] = v; }
            ++nt;
            skip_line(b);
        } else if (tok[0] == 'f' && (tok[1] == ' ' || tok[1] == '\t')) {
            b.p += 1;
            corners.clear();
            for (;;) {
                skip_ws(b);
                if (b.p >= b.end || *b.p == '\n' || *b.p == '#') break;
                long vi = read_int(b);
                long ti = 0, ni = 0;
                bool has_t = false, has_n = false;
                if (b.p < b.end && *b.p == '/') {
                    ++b.p;
                    if (b.p < b.end && *b.p != '/') { ti = read_int(b); has_t = true; }
                    if (b.p < b.end && *b.p == '/') { ++b.p; ni = read_int(b); has_n = true; }
                }
                Corner c;
                c.vi = static_cast<int>(vi > 0 ? vi - 1 : np + vi);
                c.ti = has_t ? static_cast<int>(ti > 0 ? ti - 1 : nt + ti) : -1;
                c.ni = has_n ? static_cast<int>(ni > 0 ? ni - 1 : nn + ni) : -1;
                corners.push_back(c);
            }
            // fan triangulation (tinyobj triangulate=true behaviour)
            for (size_t k = 1; k + 1 < corners.size(); ++k) {
                if (fill) {
                    const Corner tri[3] = {corners[0], corners[k], corners[k + 1]};
                    for (int j = 0; j < 3; ++j) {
                        tri_idx[ntri * 9 + j * 3] = tri[j].vi;
                        tri_idx[ntri * 9 + j * 3 + 1] = tri[j].ti;
                        tri_idx[ntri * 9 + j * 3 + 2] = tri[j].ni;
                    }
                    tri_mtl[ntri] = cur_mtl;
                    tri_shape[ntri] = cur_shape;
                }
                ++ntri;
            }
            shape_used = true;
            skip_line(b);
        } else if (!strncmp(tok, "usemtl", 6)) {
            b.p += 6;
            skip_ws(b);
            const char* s = b.p;
            while (b.p < b.end && *b.p != '\n' && *b.p != '\r') ++b.p;
            std::string name(s, static_cast<size_t>(b.p - s));
            int found = -1;
            for (size_t i = 0; i < mtl_order.size(); ++i)
                if (mtl_order[i] == name) { found = static_cast<int>(i); break; }
            if (found < 0) { mtl_order.push_back(name); found = static_cast<int>(mtl_order.size()) - 1; }
            cur_mtl = found;
            skip_line(b);
        } else if (!strncmp(tok, "mtllib", 6)) {
            b.p += 6;
            skip_ws(b);
            const char* s = b.p;
            while (b.p < b.end && *b.p != '\n' && *b.p != '\r') ++b.p;
            if (!r.mtllibs.empty()) r.mtllibs += '\n';
            r.mtllibs.append(s, static_cast<size_t>(b.p - s));
            skip_line(b);
        } else if ((tok[0] == 'o' || tok[0] == 'g') && (tok[1] == ' ' || tok[1] == '\t' || tok[1] == '\n')) {
            // material persists across groups (OBJ semantics; obj_loader.py)
            if (shape_used) { ++cur_shape; shape_used = false; }
            skip_line(b);
        } else {
            skip_line(b);
        }
    }

    r.n_pos = np;
    r.n_nrm = nn;
    r.n_tex = nt;
    r.n_tri = ntri;
    if (!fill) {
        r.usemtl_names.clear();
        for (size_t i = 0; i < mtl_order.size(); ++i) {
            if (i) r.usemtl_names += '\n';
            r.usemtl_names += mtl_order[i];
        }
    }
    return 0;
}

Result g_last;  // count() result cached for the strings ABI (single-threaded use)

}  // namespace

extern "C" {

// pass 1: fill counts; string lengths exclude terminators
int obj_count(const char* path, int64_t* out /* pos,nrm,tex,tri,names_len,mtllib_len */) {
    g_last = Result{};
    int rc = parse(path, false, g_last, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr);
    if (rc) return rc;
    out[0] = g_last.n_pos;
    out[1] = g_last.n_nrm;
    out[2] = g_last.n_tex;
    out[3] = g_last.n_tri;
    out[4] = static_cast<int64_t>(g_last.usemtl_names.size());
    out[5] = static_cast<int64_t>(g_last.mtllibs.size());
    return 0;
}

// pass 2: fill caller-allocated buffers sized from obj_count
int obj_parse(const char* path, float* pos, float* nrm, float* tex,
              int32_t* tri_idx, int32_t* tri_mtl, int32_t* tri_shape,
              char* names, char* mtllibs) {
    Result r;
    int rc = parse(path, true, r, pos, nrm, tex, tri_idx, tri_mtl, tri_shape);
    if (rc) return rc;
    memcpy(names, g_last.usemtl_names.data(), g_last.usemtl_names.size());
    memcpy(mtllibs, g_last.mtllibs.data(), g_last.mtllibs.size());
    return 0;
}
}
