// rootio.cpp — native ROOT-file reader for larcv Image2D event trees.
//
// Replacement for the reference's ROOT/larcv ingestion path
// (larcv::IOManager kREAD over TTree event storage, SURVEY.md §2.2;
// exercised at /root/reference/deploy/run_ubresnet_precropped.py:83-95).
// The reference needs the full ROOT + larcv C++ stack to read its own
// files; this reader walks the ROOT container format directly — no
// ROOT dependency — so `cli/convert` can ingest .root files in one
// step instead of requiring a PyROOT-side NPZ export.
//
// What it implements (all integers big-endian, per the ROOT on-disk
// format as documented in TFile/TKey/TBasket headers and the public
// uproot format notes):
//   * TFile header: magic, fVersion, fBEGIN, fEND (large-file variant
//     with 8-byte pointers when fVersion > 1000000).
//   * Sequential TKey record walk from fBEGIN to fEND. Every record
//     in a ROOT file is a TKey: {fNbytes i32, fVersion i16, fObjlen
//     i32, fDatime u32, fKeylen i16, fCycle i16, fSeekKey, fSeekPdir
//     (i32, or i64 when fVersion > 1000), fClassName, fName, fTitle
//     (TStrings)}. Freed slots carry a negative fNbytes and are
//     skipped. This recovers every basket without deserializing the
//     (streamer-heavy) TTree metadata object at all.
//   * TBasket keys (class "TBasket", fName = branch name, fTitle =
//     tree name) carry extra members inside the key: {i16 version,
//     i32 fBufferSize, i32 fNevBufSize, i32 fNevBuf, i32 fLast}.
//     Baskets sorted by file position give the branch's entry order;
//     cumulative fNevBuf assigns entry ranges (valid for trees written
//     sequentially, which is how larcv IOManager writes them).
//   * Compressed payloads: sequence of 9-byte-headed frames
//     {algo[2], method u8, compressed u24le, uncompressed u24le}.
//     "ZL"/"CS" → zlib, "ZS" → zstd, "L4" → lz4 (ROOT's default
//     since 6.14; 8-byte XXH64 prefix skipped, exact-size check
//     rejects corruption), "XZ" → lzma (.xz stream). zlib is linked;
//     zstd, lz4 and lzma are loaded with dlopen at their first basket
//     (hosts may carry their runtime libraries without the headers),
//     and a basket whose codec library is absent fails with an error
//     that names the codec.
//   * Per-entry boundaries inside a basket: data bytes run to
//     border = fLast - fKeylen; when fObjlen > border an offset table
//     {i32 n, n × i32 absolute positions incl. fKeylen} follows
//     (ROOT's TBasket fEntryOffset WriteArray layout); otherwise
//     entries are fixed-size fNevBufSize.
//   * larcv EventImage2D object decode (unsplit/object-wise streamed
//     branches): version-framed navigation {u32 bytecount|0x40000000,
//     i16 version} with a layout-tolerant member parser — EventBase
//     {optional TObject header, producer string, run/subrun/event as
//     u64 or u32}, then vector<Image2D>; each Image2D holds a
//     vector<float> frame (recognised by bytecount == 6 + 4n) and an
//     ImageMeta frame (origin Point2D nested-or-inline, width/height
//     doubles, rows/cols/plane as u64 or u32) in either member order.
//     Every candidate parse is cross-checked with rows*cols == npixels
//     before it is accepted, so dictionary-layout variants between
//     larcv1 (LArbys/LArCV) and larcv2 (DeepLearnPhysics) decode
//     without per-version tables. Member-wise streamed collections
//     (kStreamedMemberWise bit 0x4000 in the version: members grouped,
//     each streamed for all elements consecutively) decode through the
//     same tolerant per-member parsers, and split trees (per-member
//     leaf branches `<branch>._run/._subrun/._event/._image_v`) are
//     reassembled when the parent branch name is requested. Layouts
//     outside these still get a precise diagnostic — use
//     `cli/convert --inspect` to see what a real file contains.
//
// Pixel order: larcv Image2D stores column-major (pixel(row,col) =
// _img[col*rows+row]); rootio_image_pixels returns row-major (rows,
// cols) arrays to match the rest of the framework.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared rootio.cpp -lz -ldl, done at
// first use by ubresnet_tpu_torch/utils/native_build.py; ctypes
// bindings in ubresnet_tpu_torch/data/rootio.py.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <map>
#include <mutex>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

#include <dlfcn.h>
#include <zlib.h>

namespace {

// ---------------------------------------------------------------- cursor

struct Cursor {
  const uint8_t *p;
  const uint8_t *end;
  bool fail = false;

  Cursor(const uint8_t *ptr, size_t n) : p(ptr), end(ptr + n) {}

  bool need(size_t n) {
    if (fail || size_t(end - p) < n) {
      fail = true;
      return false;
    }
    return true;
  }
  uint8_t u8() {
    if (!need(1)) return 0;
    return *p++;
  }
  uint16_t u16() {
    if (!need(2)) return 0;
    uint16_t v = (uint16_t(p[0]) << 8) | p[1];
    p += 2;
    return v;
  }
  uint32_t u32() {
    if (!need(4)) return 0;
    uint32_t v = (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
                 (uint32_t(p[2]) << 8) | p[3];
    p += 4;
    return v;
  }
  uint64_t u64() {
    if (!need(8)) return 0;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
    p += 8;
    return v;
  }
  int16_t i16() { return int16_t(u16()); }
  int32_t i32() { return int32_t(u32()); }
  int64_t i64() { return int64_t(u64()); }
  double f64() {
    uint64_t v = u64();
    double d;
    std::memcpy(&d, &v, 8);
    return d;
  }
  float f32() {
    uint32_t v = u32();
    float f;
    std::memcpy(&f, &v, 4);
    return f;
  }
  // ROOT TString / streamed std::string: u8 length, 255 → i32 length.
  std::string tstring(size_t maxlen = 1 << 20) {
    uint32_t n = u8();
    if (n == 255) n = u32();
    if (n > maxlen || !need(n)) {
      fail = true;
      return "";
    }
    std::string s(reinterpret_cast<const char *>(p), n);
    p += n;
    return s;
  }
  void skip(size_t n) {
    if (need(n)) p += n;
  }
  size_t tell(const uint8_t *base) const { return size_t(p - base); }
};

constexpr uint32_t kByteCountMask = 0x40000000u;
constexpr uint16_t kMemberWiseBit = 0x4000u;

// A streamed-object frame: {u32 bytecount|mask, i16 version}; the
// count covers everything after the bytecount word.
struct Frame {
  bool ok = false;
  bool memberwise = false;
  uint16_t version = 0;
  const uint8_t *begin = nullptr;  // first byte after version
  const uint8_t *end = nullptr;    // first byte after the frame
};

Frame read_frame(Cursor &c) {
  Frame f;
  const uint8_t *at = c.p;
  uint32_t bc = c.u32();
  if (c.fail || !(bc & kByteCountMask)) {
    c.fail = true;
    return f;
  }
  uint32_t len = bc & ~kByteCountMask;
  if (size_t(c.end - at - 4) < len) {
    c.fail = true;
    return f;
  }
  uint16_t ver = c.u16();
  f.ok = !c.fail;
  f.memberwise = (ver & kMemberWiseBit) != 0;
  f.version = ver & ~kMemberWiseBit;
  f.begin = c.p;
  f.end = at + 4 + len;
  return f;
}

bool looks_like_frame(const Cursor &c) {
  if (size_t(c.end - c.p) < 6) return false;
  uint32_t bc = (uint32_t(c.p[0]) << 24) | (uint32_t(c.p[1]) << 16) |
                (uint32_t(c.p[2]) << 8) | c.p[3];
  if (!(bc & kByteCountMask)) return false;
  uint32_t len = bc & ~kByteCountMask;
  return size_t(c.end - c.p - 4) >= len && len >= 2;
}

// ------------------------------------------------------------ containers

struct BasketInfo {
  uint64_t seek = 0;     // file offset of the key record
  uint32_t nbytes = 0;   // total record size (key + payload)
  uint32_t objlen = 0;   // uncompressed payload size
  uint16_t keylen = 0;
  int32_t nevbufsize = 0;
  int32_t nevbuf = 0;    // entries in this basket
  int32_t last = 0;      // fKeylen + bytes of entry data
  int64_t first_entry = 0;
};

struct Branch {
  std::string tree, name;
  std::vector<BasketInfo> baskets;
  int64_t n_entries = 0;
};

struct KeyInfo {
  std::string cls, name, title;
  uint64_t seek = 0;
  uint32_t nbytes = 0;
  uint32_t objlen = 0;
};

struct DecodedImage {
  std::vector<float> px;  // column-major as stored
  double ox = 0, oy = 0, width = 0, height = 0;
  uint64_t rows = 0, cols = 0, plane = 0;
};

struct DecodedEvent {
  uint64_t run = 0, subrun = 0, event = 0;
  std::vector<DecodedImage> imgs;
};

struct RFile {
  int fd = -1;
  const uint8_t *base = nullptr;
  size_t size = 0;
  std::string error;
  std::vector<KeyInfo> keys;
  std::map<std::pair<std::string, std::string>, Branch> branches;

  std::mutex mu;
  // caches (guarded by mu)
  std::string error_snapshot;  // stable buffer for rootio_error
  std::string cached_basket_id;
  std::vector<uint8_t> cached_basket;
  std::string cached_event_id;
  DecodedEvent cached_event;
  bool cached_event_ok = false;

  ~RFile() {
    if (base) munmap(const_cast<uint8_t *>(base), size);
    if (fd >= 0) close(fd);
  }
};

// --------------------------------------------------------- decompression

// zstd, LZ4 and lzma via dlopen: a host may ship their runtime
// libraries (libzstd.so.1, liblz4.so.1, liblzma.so.5) with no dev
// header or link symlink, and the entry points used here have stable
// C ABIs. Each resolves once; null when its library is absent.
void *dlopen_first(const char *const *names) {
  for (; *names; ++names)
    if (void *h = dlopen(*names, RTLD_NOW)) return h;
  return nullptr;
}

template <typename Fn>
Fn codec_symbol(const char *const *libs, const char *sym) {
  void *h = dlopen_first(libs);
  return h ? reinterpret_cast<Fn>(dlsym(h, sym)) : nullptr;
}

const char *const kZstdLibs[] = {"libzstd.so.1", "libzstd.so", nullptr};
const char *const kLz4Libs[] = {"liblz4.so.1", "liblz4.so", nullptr};
const char *const kLzmaLibs[] = {"liblzma.so.5", "liblzma.so", nullptr};

typedef size_t (*zstd_decompress_fn)(void *, size_t, const void *, size_t);
typedef unsigned (*zstd_is_error_fn)(size_t);
typedef const char *(*zstd_error_name_fn)(size_t);
struct ZstdApi {
  zstd_decompress_fn decompress = nullptr;
  zstd_is_error_fn is_error = nullptr;
  zstd_error_name_fn error_name = nullptr;
};
const ZstdApi &zstd_api() {
  static ZstdApi api = []() {
    ZstdApi a;
    a.decompress = codec_symbol<zstd_decompress_fn>(kZstdLibs,
                                                    "ZSTD_decompress");
    a.is_error = codec_symbol<zstd_is_error_fn>(kZstdLibs, "ZSTD_isError");
    a.error_name = codec_symbol<zstd_error_name_fn>(kZstdLibs,
                                                    "ZSTD_getErrorName");
    if (!a.decompress || !a.is_error || !a.error_name) a = ZstdApi();
    return a;
  }();
  return api;
}

typedef int (*lz4_decompress_safe_fn)(const char *, char *, int, int);
lz4_decompress_safe_fn lz4_decompress_safe() {
  static lz4_decompress_safe_fn fn = codec_symbol<lz4_decompress_safe_fn>(
      kLz4Libs, "LZ4_decompress_safe");
  return fn;
}

// lzma_stream_buffer_decode(memlimit, flags, allocator, in, in_pos,
// in_size, out, out_pos, out_size) -> lzma_ret (LZMA_OK == 0)
typedef int (*lzma_buffer_decode_fn)(uint64_t *, uint32_t, const void *,
                                     const uint8_t *, size_t *, size_t,
                                     uint8_t *, size_t *, size_t);
lzma_buffer_decode_fn lzma_buffer_decode() {
  static lzma_buffer_decode_fn fn = codec_symbol<lzma_buffer_decode_fn>(
      kLzmaLibs, "lzma_stream_buffer_decode");
  return fn;
}

bool decompress_payload(const uint8_t *src, size_t srclen, size_t objlen,
                        std::vector<uint8_t> &out, std::string &err) {
  if (srclen == objlen) {  // stored uncompressed
    out.assign(src, src + srclen);
    return true;
  }
  out.clear();
  out.reserve(objlen);
  size_t pos = 0;
  while (out.size() < objlen) {
    if (pos + 9 > srclen) {
      err = "truncated compression frame header";
      return false;
    }
    const uint8_t *h = src + pos;
    char a0 = char(h[0]), a1 = char(h[1]);
    size_t csize = size_t(h[3]) | (size_t(h[4]) << 8) | (size_t(h[5]) << 16);
    size_t usize = size_t(h[6]) | (size_t(h[7]) << 8) | (size_t(h[8]) << 16);
    if (pos + 9 + csize > srclen) {
      err = "compression frame overruns payload";
      return false;
    }
    size_t off = out.size();
    out.resize(off + usize);
    if ((a0 == 'Z' && a1 == 'L') || (a0 == 'C' && a1 == 'S')) {
      uLongf dlen = uLongf(usize);
      int rc = uncompress(out.data() + off, &dlen, h + 9, uLong(csize));
      if (rc != Z_OK || dlen != usize) {
        err = "zlib inflate failed (rc=" + std::to_string(rc) + ")";
        return false;
      }
    } else if (a0 == 'Z' && a1 == 'S') {
      const ZstdApi &zstd = zstd_api();
      if (!zstd.decompress) {
        err = "zstd frame but libzstd.so.1 not loadable";
        return false;
      }
      size_t rc = zstd.decompress(out.data() + off, usize, h + 9, csize);
      if (zstd.is_error(rc) || rc != usize) {
        err = std::string("zstd decompress failed: ") +
              (zstd.is_error(rc) ? zstd.error_name(rc) : "short output");
        return false;
      }
    } else if (a0 == 'L' && a1 == '4') {
      // ROOT R__zipLZ4 layout: 8-byte XXH64 of the compressed block,
      // then the raw LZ4 block. The checksum is skipped here (no
      // public xxhash in this toolchain); LZ4_decompress_safe plus
      // the exact-output-size check still rejects corrupt frames.
      lz4_decompress_safe_fn lz4 = lz4_decompress_safe();
      if (!lz4) {
        err = "lz4 frame but liblz4.so.1 not loadable";
        return false;
      }
      if (csize < 8) {
        err = "lz4 frame shorter than its checksum prefix";
        return false;
      }
      int rc = lz4(reinterpret_cast<const char *>(h + 9 + 8),
                   reinterpret_cast<char *>(out.data() + off),
                   int(csize - 8), int(usize));
      if (rc < 0 || size_t(rc) != usize) {
        err = "lz4 decompress failed (rc=" + std::to_string(rc) + ")";
        return false;
      }
    } else if (a0 == 'X' && a1 == 'Z') {
      // ROOT R__zipLZMA: the payload is one complete .xz stream
      lzma_buffer_decode_fn lzma = lzma_buffer_decode();
      if (!lzma) {
        err = "lzma frame but liblzma.so.5 not loadable";
        return false;
      }
      uint64_t memlimit = UINT64_MAX;
      size_t in_pos = 0, out_pos = 0;
      int rc = lzma(&memlimit, 0, nullptr, h + 9, &in_pos, csize,
                    out.data() + off, &out_pos, usize);
      if (rc != 0 || out_pos != usize) {
        err = "lzma decode failed (rc=" + std::to_string(int(rc)) + ")";
        return false;
      }
    } else {
      err = std::string("unsupported compression algo '") + a0 + a1 +
            "' (supported: ZL/CS zlib, ZS zstd, L4 lz4, XZ lzma)";
      return false;
    }
    pos += 9 + csize;
  }
  if (out.size() != objlen) {
    err = "decompressed size mismatch";
    return false;
  }
  return true;
}

// ------------------------------------------------------------- file scan

bool parse_file(RFile &f) {
  Cursor c(f.base, f.size);
  if (!c.need(4) || std::memcmp(c.p, "root", 4) != 0) {
    f.error = "not a ROOT file (bad magic)";
    return false;
  }
  c.skip(4);
  uint32_t version = c.u32();
  uint32_t begin = c.u32();
  bool large = version > 1000000;
  uint64_t fend = large ? c.u64() : c.u32();
  if (c.fail || begin < 48 || fend > f.size || begin >= fend) {
    // tolerate fEND beyond mmap for truncated files: scan to file end
    if (c.fail || begin < 48 || begin >= f.size) {
      f.error = "corrupt ROOT header";
      return false;
    }
    fend = f.size;
  }

  uint64_t pos = begin;
  while (pos + 4 <= fend && pos + 4 <= f.size) {
    Cursor k(f.base + pos, f.size - pos);
    int32_t nbytes = k.i32();
    if (nbytes == 0) break;
    if (nbytes < 0) {  // freed slot: gap of -nbytes bytes
      pos += uint64_t(-int64_t(nbytes));
      continue;
    }
    if (pos + uint64_t(nbytes) > f.size) break;  // truncated tail record
    int16_t kver = k.i16();
    uint32_t objlen = k.u32();
    k.u32();  // fDatime
    uint16_t keylen = k.u16();
    k.u16();  // fCycle
    if (kver > 1000) {
      k.u64();  // fSeekKey
      k.u64();  // fSeekPdir
    } else {
      k.u32();
      k.u32();
    }
    std::string cls = k.tstring(256);
    std::string name = k.tstring(4096);
    std::string title = k.tstring(4096);
    if (k.fail || keylen < 30 || uint32_t(keylen) > uint32_t(nbytes)) {
      // unparseable record: stop the scan here rather than misalign
      f.error = "key parse failed at offset " + std::to_string(pos);
      break;
    }
    if (f.keys.size() < 100000)
      f.keys.push_back({cls, name, title, pos, uint32_t(nbytes), objlen});
    if (cls == "TBasket") {
      BasketInfo b;
      b.seek = pos;
      b.nbytes = uint32_t(nbytes);
      b.objlen = objlen;
      b.keylen = keylen;
      // basket members live inside the key, right after the strings
      k.i16();  // basket version
      k.i32();  // fBufferSize
      b.nevbufsize = k.i32();
      b.nevbuf = k.i32();
      b.last = k.i32();
      if (!k.fail) {
        auto &br = f.branches[{title, name}];
        br.tree = title;
        br.name = name;
        br.baskets.push_back(b);
      }
    }
    pos += uint64_t(nbytes);
  }

  for (auto &kv : f.branches) {
    auto &br = kv.second;
    std::sort(br.baskets.begin(), br.baskets.end(),
              [](const BasketInfo &a, const BasketInfo &b) {
                return a.seek < b.seek;
              });
    int64_t e = 0;
    for (auto &b : br.baskets) {
      b.first_entry = e;
      e += b.nevbuf;
    }
    br.n_entries = e;
  }
  if (f.branches.empty() && f.error.empty())
    f.error = "no TBasket records found (empty file, or fully-split tree "
              "with exotic layout — run --inspect)";
  else
    f.error.clear();
  return !f.branches.empty();
}

// -------------------------------------------------- entry blob extraction

const Branch *find_branch(RFile &f, const char *tree, const char *branch,
                          std::string &err) {
  auto it = f.branches.find({tree ? tree : "", branch ? branch : ""});
  if (it == f.branches.end()) {
    err = "no such branch";
    return nullptr;
  }
  return &it->second;
}

// Returns pointer+len of entry data inside the (cached) decompressed
// basket. Caller holds f.mu.
bool entry_blob(RFile &f, const Branch &br, int64_t entry,
                const uint8_t *&blob, size_t &bloblen, std::string &err) {
  const BasketInfo *bk = nullptr;
  for (const auto &b : br.baskets)
    if (entry >= b.first_entry && entry < b.first_entry + b.nevbuf) {
      bk = &b;
      break;
    }
  if (!bk) {
    err = "entry out of range";
    return false;
  }
  std::string bid = br.tree + "/" + br.name + "@" + std::to_string(bk->seek);
  if (f.cached_basket_id != bid) {
    const uint8_t *payload = f.base + bk->seek + bk->keylen;
    size_t srclen = bk->nbytes - bk->keylen;
    if (!decompress_payload(payload, srclen, bk->objlen, f.cached_basket, err))
      return false;
    f.cached_basket_id = bid;
  }
  const std::vector<uint8_t> &data = f.cached_basket;
  int64_t i = entry - bk->first_entry;
  int64_t border = int64_t(bk->last) - bk->keylen;
  if (border < 0 || size_t(border) > data.size()) {
    err = "basket fLast out of range";
    return false;
  }
  if (bk->objlen > uint64_t(border)) {
    // offset table: i32 count, count absolute positions (incl. keylen)
    Cursor c(data.data() + border, data.size() - border);
    int32_t n = c.i32();
    if (n != bk->nevbuf || c.fail) {
      err = "basket offset table malformed";
      return false;
    }
    std::vector<int64_t> off(n + 1);
    for (int32_t j = 0; j < n; ++j) off[j] = int64_t(c.i32()) - bk->keylen;
    off[n] = border;
    if (c.fail || off[i] < 0 || off[i + 1] < off[i] || off[i + 1] > border) {
      err = "basket entry offsets out of range";
      return false;
    }
    blob = data.data() + off[i];
    bloblen = size_t(off[i + 1] - off[i]);
  } else {
    if (bk->nevbufsize <= 0) {
      err = "basket has neither offsets nor fixed entry size";
      return false;
    }
    int64_t start = i * int64_t(bk->nevbufsize);
    if (start + bk->nevbufsize > border) {
      err = "fixed-size entry out of range";
      return false;
    }
    blob = data.data() + start;
    bloblen = size_t(bk->nevbufsize);
  }
  return true;
}

// ------------------------------------------------------ larcv decoding

// vector<float> STL frame signature: bytecount == 2 (version) + 4 (n)
// + 4n. Returns npx or -1.
int64_t try_vector_float(const Frame &fr, const uint8_t *&floats) {
  size_t len = size_t(fr.end - fr.begin);
  if (len < 4) return -1;
  Cursor c(fr.begin, len);
  int32_t n = c.i32();
  if (n < 0 || size_t(fr.end - c.p) != size_t(n) * 4) return -1;
  floats = c.p;
  return n;
}

// Parse an ImageMeta-like frame: [Point2D origin (nested frame of two
// doubles, or two inline doubles)] [width f64] [height f64]
// [rows, cols, plane as u64 or u32] [optional trailing members,
// ignored]. `npx` (rows*cols) disambiguates integer width; pass -1 to
// accept the first self-consistent candidate.
bool try_meta(const Frame &fr, int64_t npx, DecodedImage &out) {
  for (int intw : {8, 4}) {
    Cursor c(fr.begin, size_t(fr.end - fr.begin));
    double ox, oy;
    if (looks_like_frame(c)) {
      Frame pf = read_frame(c);
      if (!pf.ok) continue;
      Cursor pc(pf.begin, size_t(pf.end - pf.begin));
      // Point2D may itself carry a TObject-less plain pair
      ox = pc.f64();
      oy = pc.f64();
      if (pc.fail) continue;
      c.p = pf.end;
    } else {
      ox = c.f64();
      oy = c.f64();
    }
    double w = c.f64();
    double h = c.f64();
    if (c.fail) continue;
    uint64_t rows, cols, plane;
    if (intw == 8) {
      rows = c.u64();
      cols = c.u64();
      plane = c.u64();
    } else {
      rows = c.u32();
      cols = c.u32();
      plane = c.u32();
    }
    if (c.fail) continue;
    if (rows == 0 || cols == 0 || rows > (1u << 20) || cols > (1u << 20))
      continue;
    if (npx >= 0 && int64_t(rows) * int64_t(cols) != npx) continue;
    out.ox = ox;
    out.oy = oy;
    out.width = w;
    out.height = h;
    out.rows = rows;
    out.cols = cols;
    out.plane = plane;
    return true;
  }
  return false;
}

bool decode_image2d(Cursor &c, DecodedImage &out, std::string &err) {
  Frame fi = read_frame(c);
  if (!fi.ok) {
    err = "Image2D frame malformed";
    return false;
  }
  Cursor ic(fi.begin, size_t(fi.end - fi.begin));
  // Two member frames in either order: vector<float> and ImageMeta.
  Frame m1 = read_frame(ic);
  if (!m1.ok) {
    err = "Image2D first member frame malformed";
    return false;
  }
  const uint8_t *floats = nullptr;
  int64_t npx = try_vector_float(m1, floats);
  ic.p = m1.end;
  Frame m2 = read_frame(ic);
  if (!m2.ok) {
    err = "Image2D second member frame malformed";
    return false;
  }
  const Frame *metaf;
  if (npx >= 0) {
    metaf = &m2;  // order: _img then _meta
  } else {
    npx = try_vector_float(m2, floats);
    if (npx < 0) {
      err = "Image2D: no vector<float> member recognised";
      return false;
    }
    metaf = &m1;  // order: _meta then _img
  }
  if (!try_meta(*metaf, npx, out)) {
    err = "ImageMeta layout not recognised (rows*cols != npixels for "
          "all candidate layouts; npx=" + std::to_string(npx) + ")";
    return false;
  }
  out.px.resize(size_t(npx));
  Cursor fc(floats, size_t(npx) * 4);
  for (int64_t j = 0; j < npx; ++j) out.px[size_t(j)] = fc.f32();
  c.p = fi.end;
  return true;
}

// EventBase: optional TObject header (i16 version, u32 fUniqueID,
// u32 fBits — no bytecount), producer string, run/subrun/event.
bool parse_eventbase(const Frame &fr, DecodedEvent &ev) {
  // Pass 0: accept only layouts where the string + ids fill the frame
  // exactly (disambiguates TObject-header presence and id width).
  // Pass 1: tolerant — extra trailing members ignored, ids read right
  // after the producer string.
  for (int pass = 0; pass < 2; ++pass) {
    for (bool tobj : {false, true}) {
      Cursor c(fr.begin, size_t(fr.end - fr.begin));
      if (tobj) {
        c.i16();
        c.u32();
        uint32_t bits = c.u32();
        if (bits & 0x00010000) c.u16();  // kIsReferenced → pidf
        if (c.fail) continue;
      }
      std::string prod = c.tstring(4096);
      if (c.fail) continue;
      size_t left = size_t(fr.end - c.p);
      bool wide;
      if (left == 24 || (pass == 1 && left >= 24))
        wide = true;
      else if (left == 12 || (pass == 1 && left >= 12))
        wide = false;
      else
        continue;
      ev.run = wide ? c.u64() : c.u32();
      ev.subrun = wide ? c.u64() : c.u32();
      ev.event = wide ? c.u64() : c.u32();
      if (!c.fail) return true;
    }
  }
  return false;
}

// Decode a streamed vector<Image2D> frame (object-wise or
// member-wise) at the cursor into ev.imgs. Shared by the unsplit
// EventImage2D blob path and split-tree `_image_v` leaf blobs.
bool decode_image_vector(Cursor &tc, DecodedEvent &ev, std::string &err) {
  Frame fv = read_frame(tc);
  if (!fv.ok) {
    err = "vector<Image2D> frame malformed";
    return false;
  }
  if (fv.memberwise) {
    // Member-wise STL streaming (kStreamedMemberWise, TBufferFile::
    // ReadSTLMemberWise): {u16 element-class version [-1 → u32
    // checksum], i32 n}, then each data member streamed for all n
    // elements consecutively. Image2D has two object members —
    // vector<float> _img and ImageMeta _meta — each keeping its
    // per-element frame inside its group; group order follows the
    // class's member order, probed like the object-wise path.
    Cursor vc(fv.begin, size_t(fv.end - fv.begin));
    uint16_t ever = vc.u16();
    if (ever == 0xFFFFu) vc.u32();  // version -1: class checksum follows
    int32_t n = vc.i32();
    if (vc.fail || n < 0 || n > 100000) {
      err = "member-wise vector<Image2D> count malformed";
      return false;
    }
    ev.imgs.clear();
    if (n == 0) return true;
    std::vector<Frame> g1, g2;
    g1.resize(size_t(n));
    g2.resize(size_t(n));
    for (auto *g : {&g1, &g2}) {
      for (int32_t i = 0; i < n; ++i) {
        (*g)[size_t(i)] = read_frame(vc);
        if (!(*g)[size_t(i)].ok) {
          err = "member-wise group frame " + std::to_string(i) +
                " malformed";
          return false;
        }
        vc.p = (*g)[size_t(i)].end;
      }
    }
    const uint8_t *probe = nullptr;
    bool g1_is_img = try_vector_float(g1[0], probe) >= 0;
    std::vector<Frame> &imgs_g = g1_is_img ? g1 : g2;
    std::vector<Frame> &meta_g = g1_is_img ? g2 : g1;
    ev.imgs.reserve(size_t(n));
    for (int32_t i = 0; i < n; ++i) {
      DecodedImage im;
      const uint8_t *floats = nullptr;
      int64_t npx = try_vector_float(imgs_g[size_t(i)], floats);
      if (npx < 0) {
        err = "member-wise image " + std::to_string(i) +
              ": vector<float> member not recognised";
        return false;
      }
      if (!try_meta(meta_g[size_t(i)], npx, im)) {
        err = "member-wise image " + std::to_string(i) +
              ": ImageMeta layout not recognised";
        return false;
      }
      im.px.resize(size_t(npx));
      Cursor fc(floats, size_t(npx) * 4);
      for (int64_t j = 0; j < npx; ++j) im.px[size_t(j)] = fc.f32();
      ev.imgs.push_back(std::move(im));
    }
    return true;
  }
  Cursor vc(fv.begin, size_t(fv.end - fv.begin));
  int32_t n = vc.i32();
  if (vc.fail || n < 0 || n > 100000) {
    err = "vector<Image2D> count malformed";
    return false;
  }
  ev.imgs.clear();
  ev.imgs.reserve(size_t(n));
  for (int32_t i = 0; i < n; ++i) {
    DecodedImage im;
    if (!decode_image2d(vc, im, err)) {
      err = "image " + std::to_string(i) + ": " + err;
      return false;
    }
    ev.imgs.push_back(std::move(im));
  }
  return true;
}

bool decode_event(const uint8_t *blob, size_t len, DecodedEvent &ev,
                  std::string &err) {
  Cursor c(blob, len);
  Frame top = read_frame(c);
  if (!top.ok) {
    err = "EventImage2D frame malformed (split branch? run --inspect)";
    return false;
  }
  Cursor tc(top.begin, size_t(top.end - top.begin));
  // EventBase sub-frame
  Frame fb = read_frame(tc);
  if (!fb.ok) {
    err = "EventBase frame malformed";
    return false;
  }
  if (!parse_eventbase(fb, ev)) {
    err = "EventBase layout not recognised";
    return false;
  }
  tc.p = fb.end;
  return decode_image_vector(tc, ev, err);
}

// Split-tree reassembly: a split larcv branch stores each EventBase
// member in its own leaf branch (`<branch>._run`, `._subrun`,
// `._event` as raw fixed-size big-endian ints; `._producer` as a
// TString, unused here — the producer is implied by the branch name)
// and the image vector in `<branch>._image_v` (a streamed
// vector<Image2D> frame per entry). Caller holds f.mu.
bool get_event_split(RFile &f, const char *tree, const char *branch,
                     int64_t entry, DecodedEvent &ev, std::string &err) {
  std::string bn(branch ? branch : "");
  auto iv = f.branches.find({tree ? tree : "", bn + "._image_v"});
  if (iv == f.branches.end()) return false;  // not a split branch
  const uint8_t *blob;
  size_t bloblen;
  if (!entry_blob(f, iv->second, entry, blob, bloblen, err)) return false;
  Cursor tc(blob, bloblen);
  if (!decode_image_vector(tc, ev, err)) return false;
  uint64_t *ids[3] = {&ev.run, &ev.subrun, &ev.event};
  const char *leaves[3] = {"._run", "._subrun", "._event"};
  for (int i = 0; i < 3; ++i) {
    auto it = f.branches.find({tree ? tree : "", bn + leaves[i]});
    if (it == f.branches.end()) continue;  // ids optional
    const uint8_t *ib;
    size_t ilen;
    if (!entry_blob(f, it->second, entry, ib, ilen, err)) return false;
    Cursor ic(ib, ilen);
    if (ilen == 8)
      *ids[i] = ic.u64();
    else if (ilen == 4)
      *ids[i] = ic.u32();
    else {
      err = std::string("split id leaf ") + leaves[i] +
            " has unexpected width " + std::to_string(ilen);
      return false;
    }
  }
  return true;
}

// Caller holds f.mu.
bool get_event(RFile &f, const char *tree, const char *branch, int64_t entry,
               std::string &err) {
  std::string eid = std::string(tree) + "/" + branch + "#" +
                    std::to_string(entry);
  if (f.cached_event_id == eid) {
    if (!f.cached_event_ok) err = f.error;
    return f.cached_event_ok;
  }
  f.cached_event_id = eid;
  f.cached_event_ok = false;
  const Branch *br = find_branch(f, tree, branch, err);
  if (!br) {
    // not stored whole — try split-tree leaf reassembly
    std::string serr;
    f.cached_event = DecodedEvent();
    if (get_event_split(f, tree, branch, entry, f.cached_event, serr)) {
      f.cached_event_ok = true;
      return true;
    }
    if (!serr.empty()) err = "split branch: " + serr;
    f.error = err;
    return false;
  }
  const uint8_t *blob;
  size_t bloblen;
  if (!entry_blob(f, *br, entry, blob, bloblen, err)) return false;
  f.cached_event = DecodedEvent();
  if (!decode_event(blob, bloblen, f.cached_event, err)) {
    f.error = err;
    return false;
  }
  f.cached_event_ok = true;
  return true;
}

void set_err(RFile *f, const std::string &e) { f->error = e; }

void copy_str(const std::string &s, char *buf, int cap) {
  if (!buf || cap <= 0) return;
  int n = int(std::min(s.size(), size_t(cap - 1)));
  std::memcpy(buf, s.data(), size_t(n));
  buf[n] = 0;
}

// ------------------------------------------------------------------ writer
//
// Write-back path: larcv-compatible EventImage2D trees, so network
// scores flow back to the reference ecosystem (larcv IOManager(kWRITE)
// + `uburn_plane%d` producers at
// /root/reference/deploy/run_ubresnet_precropped.py:93-95,159-173).
// Emits the same container layout the reader walks (and
// tests/root_synth.py pins): TFile header + sequential TKey records;
// entries as object-wise-streamed larcv2-layout EventImage2D blobs
// (producer string + u64 run/subrun/event; Image2D = vector<float>
// frame + ImageMeta frame with nested Point2D origin) batched into
// zlib-compressed TBaskets; a TTree stub record per tree so
// class-level inspection shows the tree objects. 32-bit seeks (file
// format version 4) — files are capped at 2 GiB and the writer errors
// past that.

struct Buf {
  std::vector<uint8_t> d;

  void u8(uint8_t v) { d.push_back(v); }
  void u16(uint16_t v) {
    d.push_back(uint8_t(v >> 8));
    d.push_back(uint8_t(v));
  }
  void u32(uint32_t v) {
    d.push_back(uint8_t(v >> 24));
    d.push_back(uint8_t(v >> 16));
    d.push_back(uint8_t(v >> 8));
    d.push_back(uint8_t(v));
  }
  void i32(int32_t v) { u32(uint32_t(v)); }
  void u64(uint64_t v) {
    u32(uint32_t(v >> 32));
    u32(uint32_t(v));
  }
  void f32be(float v) {
    uint32_t u;
    std::memcpy(&u, &v, 4);
    u32(u);
  }
  void f64be(double v) {
    uint64_t u;
    std::memcpy(&u, &v, 8);
    u64(u);
  }
  void tstring(const std::string &s) {
    if (s.size() < 255) {
      u8(uint8_t(s.size()));
    } else {
      u8(255);
      u32(uint32_t(s.size()));
    }
    d.insert(d.end(), s.begin(), s.end());
  }
  void raw(const void *p, size_t n) {
    const uint8_t *b = static_cast<const uint8_t *>(p);
    d.insert(d.end(), b, b + n);
  }
  // version frame {u32 bytecount|0x40000000, i16 version} wrapping the
  // bytes appended between open_frame and close_frame
  size_t open_frame(uint16_t version) {
    size_t at = d.size();
    u32(0);  // patched in close_frame
    u16(version);
    return at;
  }
  void close_frame(size_t at) {
    uint32_t body = uint32_t(d.size() - at - 4);
    d[at] = uint8_t((body >> 24) | 0x40);
    d[at + 1] = uint8_t(body >> 16);
    d[at + 2] = uint8_t(body >> 8);
    d[at + 3] = uint8_t(body);
  }
};

struct WBranch {
  std::string tree, name;
  std::vector<std::vector<uint8_t>> pending;  // unflushed entry blobs
  long n_entries = 0;
};

struct WFile {
  FILE *fp = nullptr;
  std::string path;
  long pos = 100;  // next record position (after the 100-byte header)
  int compress = 1;
  int entries_per_basket = 4;
  std::map<std::string, WBranch> branches;
  std::string error, error_snapshot;
  std::mutex mu;

  ~WFile() {
    if (fp) std::fclose(fp);
  }
};

void wset_err(WFile *w, const std::string &e) { w->error = e; }

// zlib-compress `obj` with the 9-byte ROOT frame header; returns the
// uncompressed bytes unchanged when compression does not shrink them.
std::vector<uint8_t> w_compress(const std::vector<uint8_t> &obj,
                                bool enable) {
  const size_t kFrame = 1u << 23;  // u24 length fields cap a frame
  if (!enable || obj.empty()) return obj;
  std::vector<uint8_t> out;
  for (size_t off = 0; off < obj.size(); off += kFrame) {
    size_t n = std::min(kFrame, obj.size() - off);
    uLongf cap = compressBound(uLong(n));
    std::vector<uint8_t> tmp(cap);
    if (compress2(tmp.data(), &cap, obj.data() + off, uLong(n), 6) != Z_OK)
      return obj;
    out.push_back('Z');
    out.push_back('L');
    out.push_back(8);  // method: deflate
    out.push_back(uint8_t(cap));
    out.push_back(uint8_t(cap >> 8));
    out.push_back(uint8_t(cap >> 16));
    out.push_back(uint8_t(n));
    out.push_back(uint8_t(n >> 8));
    out.push_back(uint8_t(n >> 16));
    out.insert(out.end(), tmp.begin(), tmp.begin() + cap);
  }
  return out.size() < obj.size() ? out : obj;
}

// TKey record head: {fNbytes, fVersion=4, fObjlen, fDatime, fKeylen,
// fCycle, fSeekKey, fSeekPdir, class/name/title} (+extra inside the
// key, e.g. the TBasket members). Returns the serialized key; keylen
// out-param includes the extra bytes.
std::vector<uint8_t> w_key(const std::string &cls, const std::string &name,
                           const std::string &title, uint32_t objlen,
                           size_t payload_len, long seek,
                           const std::vector<uint8_t> &extra, int *keylen) {
  Buf s;
  s.tstring(cls);
  s.tstring(name);
  s.tstring(title);
  int klen = 4 + 2 + 4 + 4 + 2 + 2 + 4 + 4 + int(s.d.size() + extra.size());
  Buf k;
  k.i32(int32_t(klen + payload_len));
  k.u16(4);  // key version (32-bit seeks)
  k.u32(objlen);
  k.u32(0);  // fDatime
  k.u16(uint16_t(klen));
  k.u16(1);  // fCycle
  k.i32(int32_t(seek));
  k.i32(100);  // fSeekPdir: the TFile directory record at fBEGIN
  k.raw(s.d.data(), s.d.size());
  k.raw(extra.data(), extra.size());
  if (keylen) *keylen = klen;
  return k.d;
}

bool w_put(WFile *w, const std::string &cls, const std::string &name,
           const std::string &title, const std::vector<uint8_t> &obj,
           bool compress, const std::vector<uint8_t> &extra) {
  std::vector<uint8_t> payload = w_compress(obj, compress && w->compress);
  std::vector<uint8_t> key = w_key(cls, name, title, uint32_t(obj.size()),
                                   payload.size(), w->pos, extra, nullptr);
  long total = long(key.size() + payload.size());
  if (w->pos + total > 0x7fff0000L) {
    wset_err(w, "file exceeds the 2 GiB 32-bit-seek format limit");
    return false;
  }
  if (std::fwrite(key.data(), 1, key.size(), w->fp) != key.size() ||
      (payload.size() &&
       std::fwrite(payload.data(), 1, payload.size(), w->fp) !=
           payload.size())) {
    wset_err(w, "write failed: " + w->path);
    return false;
  }
  w->pos += total;
  return true;
}

// One object-wise-streamed EventImage2D blob, larcv2 layout (the
// reader accepts every layout variant; the writer emits the common
// one: u64 ids, _img before _meta, nested Point2D origin, no TObject
// header — tests/root_synth.py stream_event_image2d defaults).
// images: nimg triples of (rows, cols, plane, ox, oy, width, height)
// metas + row-major pixel data.
std::vector<uint8_t> w_event_blob(const char *producer, const long *rse,
                                  long nimg, const long *rows,
                                  const long *cols, const long *planes,
                                  const double *meta4, const float *px) {
  Buf b;
  size_t ev = b.open_frame(10);
  {
    size_t base = b.open_frame(3);
    b.tstring(producer);
    b.u64(uint64_t(rse[0]));
    b.u64(uint64_t(rse[1]));
    b.u64(uint64_t(rse[2]));
    b.close_frame(base);
  }
  {
    size_t vec = b.open_frame(6);
    b.i32(int32_t(nimg));
    const float *p = px;
    for (long i = 0; i < nimg; ++i) {
      long r = rows[i], c = cols[i];
      size_t img = b.open_frame(5);
      {
        // vector<float> _img, column-major (_img[col*rows+row])
        size_t vf = b.open_frame(6);
        b.i32(int32_t(r * c));
        for (long col = 0; col < c; ++col)
          for (long row = 0; row < r; ++row) b.f32be(p[row * c + col]);
        b.close_frame(vf);
      }
      {
        size_t mf = b.open_frame(4);
        size_t origin = b.open_frame(2);
        b.f64be(meta4[4 * i + 0]);  // origin x (min_x)
        b.f64be(meta4[4 * i + 1]);  // origin y (max_y — top-left)
        b.close_frame(origin);
        b.f64be(meta4[4 * i + 2]);  // width
        b.f64be(meta4[4 * i + 3]);  // height
        b.u64(uint64_t(r));
        b.u64(uint64_t(c));
        b.u64(uint64_t(planes[i]));
        b.close_frame(mf);
      }
      b.close_frame(img);
      p += r * c;
    }
    b.close_frame(vec);
  }
  b.close_frame(ev);
  return b.d;
}

bool w_flush_branch(WFile *w, WBranch &br) {
  if (br.pending.empty()) return true;
  size_t datalen = 0;
  for (const auto &e : br.pending) datalen += e.size();
  // keylen must be known for fLast and the offsets table: dry-build
  std::vector<uint8_t> extra_probe;
  {
    Buf e;
    e.u16(3);
    e.i32(32000);
    e.i32(0);
    e.i32(0);
    e.i32(0);
    e.u8(0);
    extra_probe = e.d;
  }
  int keylen = 0;
  w_key("TBasket", br.name, br.tree, 0, 0, 0, extra_probe, &keylen);
  Buf obj;
  for (const auto &e : br.pending) obj.raw(e.data(), e.size());
  // fEntryOffset table: absolute positions including the key bytes
  obj.i32(int32_t(br.pending.size()));
  {
    int32_t acc = keylen;
    for (const auto &e : br.pending) {
      obj.i32(acc);
      acc += int32_t(e.size());
    }
  }
  Buf extra;
  extra.u16(3);                              // basket version
  extra.i32(32000);                          // fBufferSize
  extra.i32(0);                              // fNevBufSize (offsets rule)
  extra.i32(int32_t(br.pending.size()));     // fNevBuf
  extra.i32(int32_t(keylen + datalen));      // fLast
  extra.u8(0);
  bool ok = w_put(w, "TBasket", br.name, br.tree, obj.d, true, extra.d);
  if (ok) br.n_entries += long(br.pending.size());
  br.pending.clear();
  return ok;
}

}  // namespace

// ------------------------------------------------------------- C exports

extern "C" {

// How each codec is provided: "zlib=linked zstd=dlopen lz4=dlopen
// lzma=absent" (absent: its library did not load; its baskets fail).
// Returns the length written, or -1 when cap is too small.
int rootio_codecs(char *buf, int cap) {
  std::string s = "zlib=linked";
  s += std::string(" zstd=") + (zstd_api().decompress ? "dlopen" : "absent");
  s += std::string(" lz4=") + (lz4_decompress_safe() ? "dlopen" : "absent");
  s += std::string(" lzma=") + (lzma_buffer_decode() ? "dlopen" : "absent");
  if (int(s.size()) >= cap) return -1;
  std::memcpy(buf, s.c_str(), s.size() + 1);
  return int(s.size());
}

void *rootio_open(const char *path) {
  auto *f = new RFile();
  f->fd = ::open(path, O_RDONLY);
  if (f->fd < 0) {
    delete f;
    return nullptr;
  }
  struct stat st;
  if (fstat(f->fd, &st) != 0 || st.st_size < 64) {
    delete f;
    return nullptr;
  }
  f->size = size_t(st.st_size);
  void *m = mmap(nullptr, f->size, PROT_READ, MAP_PRIVATE, f->fd, 0);
  if (m == MAP_FAILED) {
    delete f;
    return nullptr;
  }
  f->base = static_cast<const uint8_t *>(m);
  parse_file(*f);  // keys/branches populated; error kept for inspection
  if (f->size < 8 || std::memcmp(f->base, "root", 4) != 0) {
    delete f;  // not a ROOT file at all — nothing to inspect
    return nullptr;
  }
  return f;
}

const char *rootio_error(void *h) {
  if (!h) return "null handle";
  RFile *f = static_cast<RFile *>(h);
  // snapshot under the lock: error is reassigned by API calls on other
  // threads, so returning its c_str() directly could dangle. ctypes
  // callers .decode() immediately, so the snapshot buffer is stable
  // for the read.
  std::lock_guard<std::mutex> lk(f->mu);
  f->error_snapshot = f->error;
  return f->error_snapshot.c_str();
}

void rootio_close(void *h) { delete static_cast<RFile *>(h); }

long rootio_n_branches(void *h) {
  return long(static_cast<RFile *>(h)->branches.size());
}

int rootio_branch_info(void *h, long i, char *tree, int treecap, char *branch,
                       int brcap, long *n_entries, long *n_baskets) {
  auto *f = static_cast<RFile *>(h);
  if (i < 0 || size_t(i) >= f->branches.size()) return -1;
  auto it = f->branches.begin();
  std::advance(it, i);
  copy_str(it->second.tree, tree, treecap);
  copy_str(it->second.name, branch, brcap);
  if (n_entries) *n_entries = long(it->second.n_entries);
  if (n_baskets) *n_baskets = long(it->second.baskets.size());
  return 0;
}

long rootio_n_keys(void *h) {
  return long(static_cast<RFile *>(h)->keys.size());
}

int rootio_key_info(void *h, long i, char *cls, int clscap, char *name,
                    int namecap, char *title, int titlecap, long *nbytes,
                    long *objlen, long *seek) {
  auto *f = static_cast<RFile *>(h);
  if (i < 0 || size_t(i) >= f->keys.size()) return -1;
  const KeyInfo &k = f->keys[size_t(i)];
  copy_str(k.cls, cls, clscap);
  copy_str(k.name, name, namecap);
  copy_str(k.title, title, titlecap);
  if (nbytes) *nbytes = long(k.nbytes);
  if (objlen) *objlen = long(k.objlen);
  if (seek) *seek = long(k.seek);
  return 0;
}

long rootio_entry_size(void *h, const char *tree, const char *branch,
                       long entry) {
  auto *f = static_cast<RFile *>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  std::string err;
  const Branch *br = find_branch(*f, tree, branch, err);
  if (!br) {
    set_err(f, err);
    return -1;
  }
  const uint8_t *blob;
  size_t bloblen;
  if (!entry_blob(*f, *br, entry, blob, bloblen, err)) {
    set_err(f, err);
    return -1;
  }
  return long(bloblen);
}

long rootio_read_raw(void *h, const char *tree, const char *branch, long entry,
                     uint8_t *out, long cap) {
  auto *f = static_cast<RFile *>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  std::string err;
  const Branch *br = find_branch(*f, tree, branch, err);
  if (!br) {
    set_err(f, err);
    return -1;
  }
  const uint8_t *blob;
  size_t bloblen;
  if (!entry_blob(*f, *br, entry, blob, bloblen, err)) {
    set_err(f, err);
    return -1;
  }
  if (out) {
    if (cap < long(bloblen)) {
      // caller supplied a buffer but it is too small: a real error,
      // not a size query — report it so the binding's IOError carries
      // the cause instead of a stale/empty message
      set_err(f, "output buffer too small (" + std::to_string(cap) +
                     " < " + std::to_string(bloblen) + " bytes)");
      return -2;
    }
    std::memcpy(out, blob, bloblen);
  }
  return long(bloblen);
}

int rootio_event_info(void *h, const char *tree, const char *branch,
                      long entry, long *nimages, long *rse) {
  auto *f = static_cast<RFile *>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  std::string err;
  if (!get_event(*f, tree, branch, entry, err)) {
    set_err(f, err);
    return -1;
  }
  if (nimages) *nimages = long(f->cached_event.imgs.size());
  if (rse) {
    rse[0] = long(f->cached_event.run);
    rse[1] = long(f->cached_event.subrun);
    rse[2] = long(f->cached_event.event);
  }
  return 0;
}

// meta7: [origin_x, origin_y, width, height, rows, cols, plane]
int rootio_image_meta(void *h, const char *tree, const char *branch,
                      long entry, int idx, double *meta7) {
  auto *f = static_cast<RFile *>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  std::string err;
  if (!get_event(*f, tree, branch, entry, err)) {
    set_err(f, err);
    return -1;
  }
  const auto &imgs = f->cached_event.imgs;
  if (idx < 0 || size_t(idx) >= imgs.size()) {
    set_err(f, "image index out of range");
    return -1;
  }
  const DecodedImage &im = imgs[size_t(idx)];
  meta7[0] = im.ox;
  meta7[1] = im.oy;
  meta7[2] = im.width;
  meta7[3] = im.height;
  meta7[4] = double(im.rows);
  meta7[5] = double(im.cols);
  meta7[6] = double(im.plane);
  return 0;
}

// Fills `out` row-major (rows, cols); returns npx. larcv stores
// column-major (pixel(r,c) = _img[c*rows + r]).
long rootio_image_pixels(void *h, const char *tree, const char *branch,
                         long entry, int idx, float *out, long cap) {
  auto *f = static_cast<RFile *>(h);
  std::lock_guard<std::mutex> lk(f->mu);
  std::string err;
  if (!get_event(*f, tree, branch, entry, err)) {
    set_err(f, err);
    return -1;
  }
  const auto &imgs = f->cached_event.imgs;
  if (idx < 0 || size_t(idx) >= imgs.size()) {
    set_err(f, "image index out of range");
    return -1;
  }
  const DecodedImage &im = imgs[size_t(idx)];
  long npx = long(im.px.size());
  if (out) {
    if (cap < npx) {
      set_err(f, "output buffer too small (" + std::to_string(cap) +
                     " < " + std::to_string(npx) + " pixels)");
      return -2;
    }
    size_t rows = im.rows, cols = im.cols;
    for (size_t col = 0; col < cols; ++col)
      for (size_t row = 0; row < rows; ++row)
        out[row * cols + col] = im.px[col * rows + row];
  }
  return npx;
}

// ---------------------------------------------------------- writer exports

void *rootw_open(const char *path, int compress, int entries_per_basket) {
  auto *w = new WFile();
  w->path = path;
  w->compress = compress ? 1 : 0;
  if (entries_per_basket > 0) w->entries_per_basket = entries_per_basket;
  w->fp = std::fopen(path, "wb");
  if (!w->fp) {
    delete w;
    return nullptr;
  }
  // 100-byte header placeholder (finalized in rootw_close)
  std::vector<uint8_t> hdr(100, 0);
  if (std::fwrite(hdr.data(), 1, hdr.size(), w->fp) != hdr.size()) {
    delete w;
    return nullptr;
  }
  // first record: the TFile directory object (40-byte stub body)
  std::vector<uint8_t> dir(40, 0), no_extra;
  if (!w_put(w, "TFile", path, "", dir, false, no_extra)) {
    delete w;
    return nullptr;
  }
  return w;
}

const char *rootw_error(void *h) {
  if (!h) return "null handle";
  WFile *w = static_cast<WFile *>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  w->error_snapshot = w->error;
  return w->error_snapshot.c_str();
}

// Append one EventImage2D entry to producer's tree
// (tree image2d_{producer}_tree, branch image2d_{producer}_branch —
// the larcv naming the reference scripts address,
// run_ubresnet_precropped.py:159-173). meta4: nimg × [origin_x,
// origin_y(top), width, height]; px: concatenated row-major pixels.
int rootw_write_entry(void *h, const char *producer, const long *rse,
                      long nimg, const long *rows, const long *cols,
                      const long *planes, const double *meta4,
                      const float *px) {
  auto *w = static_cast<WFile *>(h);
  std::lock_guard<std::mutex> lk(w->mu);
  std::string prod(producer);
  WBranch &br = w->branches[prod];
  if (br.tree.empty()) {
    br.tree = "image2d_" + prod + "_tree";
    br.name = "image2d_" + prod + "_branch";
  }
  br.pending.push_back(w_event_blob(producer, rse, nimg, rows, cols,
                                    planes, meta4, px));
  if (long(br.pending.size()) >= w->entries_per_basket)
    return w_flush_branch(w, br) ? 0 : -1;
  return 0;
}

int rootw_close(void *h) {
  auto *w = static_cast<WFile *>(h);
  bool ok = true;
  {
    std::lock_guard<std::mutex> lk(w->mu);
    std::vector<uint8_t> no_extra;
    for (auto &kv : w->branches) {
      if (!w_flush_branch(w, kv.second)) {
        ok = false;
        break;
      }
      // TTree stub record: class-level inspection (rootio_key_info /
      // cli convert --inspect) sees the tree object; the reader's
      // branch recovery walks the baskets and ignores the body.
      Buf stub;
      stub.u64(uint64_t(kv.second.n_entries));
      if (ok && !w_put(w, "TTree", kv.second.tree, "larcv image2d tree",
                       stub.d, false, no_extra))
        ok = false;
    }
    if (ok) {
      // finalize the header: magic, fVersion, fBEGIN, fEND, free-list
      // fields zero, fNbytesName, fUnits=4, fCompress, fSeekInfo 0
      Buf hdr;
      hdr.raw("root", 4);
      hdr.i32(62804);     // format version
      hdr.i32(100);       // fBEGIN
      hdr.i32(int32_t(w->pos));  // fEND
      hdr.i32(0);         // fSeekFree
      hdr.i32(0);         // fNbytesFree
      hdr.i32(0);         // nfree
      hdr.i32(40);        // fNbytesName
      hdr.u8(4);          // fUnits
      hdr.i32(w->compress ? 101 : 0);  // fCompress (zlib level 1 tag)
      hdr.i32(0);         // fSeekInfo
      hdr.i32(0);         // fNbytesInfo
      hdr.d.resize(100, 0);
      ok = std::fseek(w->fp, 0, SEEK_SET) == 0 &&
           std::fwrite(hdr.d.data(), 1, 100, w->fp) == 100 &&
           std::fflush(w->fp) == 0;
      if (!ok) wset_err(w, "finalize failed: " + w->path);
    }
  }
  if (ok) {
    delete w;
    return 0;
  }
  return -1;  // handle kept alive so rootw_error can be read
}

void rootw_abort(void *h) { delete static_cast<WFile *>(h); }

}  // extern "C"
