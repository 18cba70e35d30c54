// Native trajectory-ingest engine of the PyTorch port: its own copy of
// visual_foresight_tpu/native/ingest.cpp, with the same C ABI.
//
// The host half of the training input pipeline (the reference's tf.data
// reader, examples/dataset_reader.py:43-152): this file streams GZIP
// TFRecord shards, parses tf.train.Example protos, decodes JPEG or raw
// image bytes, and assembles shuffled uint8/f32 batches into caller-owned
// buffers.  The device half (the cast to float and the 1/255 scale) runs on
// the card, in data/fused_ingest.py::device_ingest.  Python binds it with
// ctypes (data/fused_ingest.py); ops/_build.py::build_host compiles it at
// first use into build/native/.  Built with -DVFI_NO_JPEG (where jpeglib.h
// is missing) it decodes raw frames only: a JPEG frame fails to decode.
//
// Threading: a pool of decode workers pulls file shards, each streams
// records through a zlib inflater, parses only the requested feature keys,
// and pushes fixed-size Traj slabs into a mutex-guarded shuffle pool.  The
// consumer (vfi_next, called from Python) draws uniformly from the pool
// once it is warm -- an O(1)-memory approximation of a shuffle buffer.
//
// C ABI:
//   void*  vfi_open(const char* config_text);
//   int    vfi_next(void* h, uint8_t* images, float* states, float* actions);
//   void   vfi_close(void* h);
//   double vfi_frames_decoded(void* h);
//   const char* vfi_error(void* h);

#include <cstdio>

#ifndef VFI_NO_JPEG
#include <jpeglib.h>
#include <setjmp.h>
#endif
#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// config
// ---------------------------------------------------------------------------

struct Config {
  int batch = 16;
  int T = 30;
  int ncam = 1;
  int height = 48, width = 64;
  int adim = 3, sdim = 3;
  int threads = 2;
  int shuffle = 1;
  int num_epochs = 0;  // 0 = repeat forever
  int pool_size = 256;  // shuffle pool (trajectories)
  unsigned seed = 1234;
  std::string image_key = "env/image_view{c}/encoded";
  std::string state_key = "env/state";
  std::string action_key = "policy/actions";
  std::vector<std::string> files;
};

// The next whitespace-separated token of line from *pos ("" at its end).
// The config is parsed without iostreams: where the compiler links
// libstdc++ statically into this library, its streams' locale is not set
// up in the host process, and reads fail or crash.
std::string next_token(const std::string& line, size_t* pos) {
  size_t b = line.find_first_not_of(" \t\r", *pos);
  if (b == std::string::npos) {
    *pos = line.size();
    return "";
  }
  size_t e = line.find_first_of(" \t\r", b);
  if (e == std::string::npos) e = line.size();
  *pos = e;
  return line.substr(b, e - b);
}

Config parse_config(const char* text, std::string* err) {
  Config c;
  const std::string all(text);
  const std::pair<const char*, int*> ints[] = {
      {"batch", &c.batch},     {"T", &c.T},
      {"ncam", &c.ncam},       {"height", &c.height},
      {"width", &c.width},     {"adim", &c.adim},
      {"sdim", &c.sdim},       {"threads", &c.threads},
      {"shuffle", &c.shuffle}, {"num_epochs", &c.num_epochs},
      {"pool_size", &c.pool_size}};
  const std::pair<const char*, std::string*> strings[] = {
      {"image_key", &c.image_key},
      {"state_key", &c.state_key},
      {"action_key", &c.action_key}};
  for (size_t start = 0; start <= all.size();) {
    size_t end = all.find('\n', start);
    if (end == std::string::npos) end = all.size();
    const std::string line = all.substr(start, end - start);
    start = end + 1;
    if (line.empty() || line[0] == '#') continue;
    size_t pos = 0;
    // a line may carry several key/value pairs (e.g. "adim 4 sdim 5")
    for (std::string key = next_token(line, &pos); !key.empty();
         key = next_token(line, &pos)) {
      if (key == "file") {  // a file path consumes the rest of the line
        size_t s = line.find_first_not_of(" \t", pos);
        if (s != std::string::npos) c.files.push_back(line.substr(s));
        break;
      }
      const std::string value = next_token(line, &pos);
      bool known = false;
      for (const auto& f : ints)
        if (key == f.first) {
          *f.second = static_cast<int>(strtol(value.c_str(), nullptr, 10));
          known = true;
        }
      for (const auto& f : strings)
        if (key == f.first) {
          *f.second = value;
          known = true;
        }
      if (key == "seed") {
        c.seed = static_cast<unsigned>(strtoul(value.c_str(), nullptr, 10));
        known = true;
      }
      if (!known) {
        *err = "unknown config key: " + key;
        break;
      }
    }
  }
  if (c.files.empty()) *err = "no input files";
  return c;
}

// ---------------------------------------------------------------------------
// streaming gzip -> TFRecord payloads
// ---------------------------------------------------------------------------

// Incremental inflater over a FILE*; hands out whole TFRecord payloads.
// Record framing: u64 length | u32 masked-crc(length) | payload | u32 crc.
// CRCs are not re-validated here -- the gzip container already checksums the
// stream (reference readers also ran with default no-verify).
class RecordStream {
 public:
  explicit RecordStream(const std::string& path) {
    f_ = fopen(path.c_str(), "rb");
    memset(&z_, 0, sizeof(z_));
    // 15+32: auto-detect zlib/gzip headers
    ok_ = f_ && inflateInit2(&z_, 15 + 32) == Z_OK;
  }
  ~RecordStream() {
    if (f_) fclose(f_);
    if (ok_) inflateEnd(&z_);
  }

  bool ok() const { return ok_; }

  // Returns false at clean EOF or error.
  bool next(std::string* payload) {
    uint8_t header[12];
    if (!read_exact(header, 12)) return false;
    uint64_t len;
    memcpy(&len, header, 8);  // little-endian host assumed (x86/ARM LE)
    if (len > (1ull << 31)) return false;  // corrupt
    payload->resize(len);
    if (!read_exact(reinterpret_cast<uint8_t*>(&(*payload)[0]), len))
      return false;
    uint8_t footer[4];
    return read_exact(footer, 4);
  }

 private:
  bool read_exact(uint8_t* dst, size_t n) {
    while (n > 0) {
      if (out_pos_ < out_len_) {
        size_t take = std::min(n, out_len_ - out_pos_);
        memcpy(dst, out_ + out_pos_, take);
        out_pos_ += take;
        dst += take;
        n -= take;
        continue;
      }
      if (!refill()) return false;
    }
    return true;
  }

  bool refill() {
    if (!ok_) return false;
    if (z_.avail_in == 0) {
      size_t got = fread(in_, 1, sizeof(in_), f_);
      if (got == 0 && z_.avail_in == 0) return false;
      z_.next_in = in_;
      z_.avail_in = static_cast<uInt>(got);
    }
    z_.next_out = out_;
    z_.avail_out = sizeof(out_);
    int rc = inflate(&z_, Z_NO_FLUSH);
    if (rc == Z_STREAM_END) {
      // concatenated gzip members (one per flush in some writers)
      out_len_ = sizeof(out_) - z_.avail_out;
      out_pos_ = 0;
      inflateReset2(&z_, 15 + 32);
      return out_len_ > 0 || z_.avail_in > 0 || !feof(f_);
    }
    if (rc != Z_OK && rc != Z_BUF_ERROR) {
      ok_ = false;
      return false;
    }
    out_len_ = sizeof(out_) - z_.avail_out;
    out_pos_ = 0;
    return out_len_ > 0;
  }

  FILE* f_ = nullptr;
  z_stream z_;
  bool ok_ = false;
  uint8_t in_[1 << 16];
  uint8_t out_[1 << 16];
  size_t out_pos_ = 0, out_len_ = 0;
};

// ---------------------------------------------------------------------------
// minimal protobuf walker for tf.train.Example
// ---------------------------------------------------------------------------

struct Span {
  const uint8_t* p;
  size_t n;
};

inline bool read_varint(const uint8_t*& p, const uint8_t* end, uint64_t* v) {
  uint64_t r = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    r |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *v = r;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Walks one level of proto fields; invokes fn(field_number, wire, span/value).
template <typename Fn>
bool walk(Span s, Fn&& fn) {
  const uint8_t* p = s.p;
  const uint8_t* end = s.p + s.n;
  while (p < end) {
    uint64_t key;
    if (!read_varint(p, end, &key)) return false;
    uint32_t field = static_cast<uint32_t>(key >> 3);
    uint32_t wire = key & 7;
    if (wire == 0) {
      uint64_t v;
      if (!read_varint(p, end, &v)) return false;
      fn(field, wire, Span{nullptr, 0}, v);
    } else if (wire == 2) {
      uint64_t len;
      if (!read_varint(p, end, &len) || p + len > end) return false;
      fn(field, wire, Span{p, static_cast<size_t>(len)}, 0);
      p += len;
    } else if (wire == 5) {
      if (p + 4 > end) return false;
      fn(field, wire, Span{p, 4}, 0);
      p += 4;
    } else if (wire == 1) {
      if (p + 8 > end) return false;
      fn(field, wire, Span{p, 8}, 0);
      p += 8;
    } else {
      return false;
    }
  }
  return true;
}

// Feature slot descriptors: where a parsed feature lands in the Traj slab.
enum class Kind : uint8_t { kImage, kState, kAction };

struct Slot {
  Kind kind;
  int t;
  int cam;  // images only
};

// First bytes value of a BytesList feature (field 1 -> field 1).
bool bytes_value(Span feature, Span* out) {
  bool found = false;
  walk(feature, [&](uint32_t f, uint32_t w, Span s, uint64_t) {
    if (f == 1 && w == 2 && !found) {
      walk(s, [&](uint32_t f2, uint32_t w2, Span s2, uint64_t) {
        if (f2 == 1 && w2 == 2 && !found) {
          *out = s2;
          found = true;
        }
      });
    }
  });
  return found;
}

// FloatList (field 2 -> packed field 1) into dst[0:n); returns count copied.
size_t float_values(Span feature, float* dst, size_t n) {
  size_t copied = 0;
  walk(feature, [&](uint32_t f, uint32_t w, Span s, uint64_t) {
    if (f == 2 && w == 2) {
      walk(s, [&](uint32_t f2, uint32_t w2, Span s2, uint64_t) {
        if (f2 == 1 && w2 == 2) {  // packed
          size_t cnt = std::min(n - copied, s2.n / 4);
          memcpy(dst + copied, s2.p, cnt * 4);
          copied += cnt;
        } else if (f2 == 1 && w2 == 5 && copied < n) {  // unpacked
          memcpy(dst + copied, s2.p, 4);
          copied += 1;
        }
      });
    }
  });
  return copied;
}

// ---------------------------------------------------------------------------
// image decode: raw bytes or JPEG (magic ff d8)
// ---------------------------------------------------------------------------

#ifdef VFI_NO_JPEG
#define VFI_JPEG_NOTE "; this build decodes no JPEG (built without libjpeg)"
#else
#define VFI_JPEG_NOTE ""

struct JpegErr {
  jpeg_error_mgr pub;
  jmp_buf env;
  bool failed;
};

// libjpeg's contract: an overriding error_exit must NOT return (the library
// would continue with inconsistent state).  longjmp back to the decode call.
void jpeg_err_exit(j_common_ptr cinfo) {
  auto* err = reinterpret_cast<JpegErr*>(cinfo->err);
  err->failed = true;
  longjmp(err->env, 1);
}
#endif

// Decode src into dst (h*w*3, RGB).  Handles raw uint8 planes and JPEG;
// JPEGs whose dimensions differ from (h, w) are bilinearly resized.
bool decode_image(Span src, uint8_t* dst, int h, int w) {
  const size_t raw_n = static_cast<size_t>(h) * w * 3;
  if (src.n == raw_n && !(src.n >= 2 && src.p[0] == 0xFF && src.p[1] == 0xD8)) {
    memcpy(dst, src.p, raw_n);
    return true;
  }
  if (!(src.n >= 2 && src.p[0] == 0xFF && src.p[1] == 0xD8)) return false;
#ifdef VFI_NO_JPEG
  return false;
#else
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = jpeg_err_exit;
  jerr.failed = false;
  std::vector<uint8_t> buf;
  int sh = 0, sw = 0;
  jpeg_create_decompress(&cinfo);
  if (setjmp(jerr.env)) {  // fatal decode error lands here
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(src.p),
               static_cast<unsigned long>(src.n));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  sh = cinfo.output_height;
  sw = cinfo.output_width;
  buf.resize(static_cast<size_t>(sh) * sw * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = buf.data() + static_cast<size_t>(cinfo.output_scanline) * sw * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);

  if (sh == h && sw == w) {
    memcpy(dst, buf.data(), raw_n);
    return true;
  }
  // bilinear resize (align_corners=false, matching jax.image.resize 'linear')
  for (int y = 0; y < h; ++y) {
    float fy = (y + 0.5f) * sh / h - 0.5f;
    int y0 = fy < 0 ? 0 : static_cast<int>(fy);
    int y1 = std::min(y0 + 1, sh - 1);
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < w; ++x) {
      float fx = (x + 0.5f) * sw / w - 0.5f;
      int x0 = fx < 0 ? 0 : static_cast<int>(fx);
      int x1 = std::min(x0 + 1, sw - 1);
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      for (int ch = 0; ch < 3; ++ch) {
        float v00 = buf[(static_cast<size_t>(y0) * sw + x0) * 3 + ch];
        float v01 = buf[(static_cast<size_t>(y0) * sw + x1) * 3 + ch];
        float v10 = buf[(static_cast<size_t>(y1) * sw + x0) * 3 + ch];
        float v11 = buf[(static_cast<size_t>(y1) * sw + x1) * 3 + ch];
        float v = (1 - wy) * ((1 - wx) * v00 + wx * v01) +
                  wy * ((1 - wx) * v10 + wx * v11);
        dst[(static_cast<size_t>(y) * w + x) * 3 + ch] =
            static_cast<uint8_t>(v + 0.5f);
      }
    }
  }
  return true;
#endif
}

// ---------------------------------------------------------------------------
// engine
// ---------------------------------------------------------------------------

struct Traj {
  std::vector<uint8_t> images;  // T*ncam*H*W*3
  std::vector<float> states;    // T*sdim
  std::vector<float> actions;   // T*adim
};

std::string key_for_cam(const std::string& tmpl, int cam) {
  std::string out = tmpl;
  size_t pos = out.find("{c}");
  if (pos != std::string::npos) out.replace(pos, 3, std::to_string(cam));
  return out;
}

class Engine {
 public:
  explicit Engine(const Config& cfg) : cfg_(cfg), rng_(cfg.seed) {
    // feature-name -> slab slot table, built once
    for (int t = 0; t < cfg_.T; ++t) {
      for (int c = 0; c < cfg_.ncam; ++c) {
        slots_[std::to_string(t) + "/" + key_for_cam(cfg_.image_key, c)] =
            Slot{Kind::kImage, t, c};
      }
      slots_[std::to_string(t) + "/" + cfg_.state_key] = Slot{Kind::kState, t, 0};
      slots_[std::to_string(t) + "/" + cfg_.action_key] =
          Slot{Kind::kAction, t, 0};
    }
    file_order_.resize(cfg_.files.size());
    for (size_t i = 0; i < file_order_.size(); ++i) file_order_[i] = i;
    if (cfg_.shuffle) std::shuffle(file_order_.begin(), file_order_.end(), rng_);
    n_workers_ = std::max(1, cfg_.threads);
    for (int i = 0; i < n_workers_; ++i)
      workers_.emplace_back([this] { worker_loop(); });
  }

  ~Engine() {
    {
      std::lock_guard<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_space_.notify_all();
    cv_data_.notify_all();
    for (auto& t : workers_) t.join();
  }

  // Fills one batch. Returns 0 for a full batch, 1 when exhausted with no
  // rows filled (finite epochs only), and -rows (rows in [1, batch-1]) when
  // the pool drained mid-batch: the leading `rows` rows of the caller's
  // buffers hold the trailing partial batch and the next call returns 1.
  int next(uint8_t* images, float* states, float* actions) {
    const size_t img_n = traj_img_elems();
    const size_t st_n = static_cast<size_t>(cfg_.T) * cfg_.sdim;
    const size_t ac_n = static_cast<size_t>(cfg_.T) * cfg_.adim;
    for (int b = 0; b < cfg_.batch; ++b) {
      std::unique_ptr<Traj> tr;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_data_.wait(lk, [this] {
          return stop_ || !pool_.empty() || (done_producing_ && pool_.empty());
        });
        if (pool_.empty()) return b == 0 ? 1 : -b;  // exhausted
        if (cfg_.shuffle) {
          size_t idx = std::uniform_int_distribution<size_t>(
              0, pool_.size() - 1)(rng_);
          std::swap(pool_[idx], pool_.back());
          tr = std::move(pool_.back());
          pool_.pop_back();
        } else {  // strict FIFO for deterministic eval passes
          tr = std::move(pool_.front());
          pool_.erase(pool_.begin());
        }
      }
      cv_space_.notify_one();
      memcpy(images + b * img_n, tr->images.data(), img_n);
      memcpy(states + b * st_n, tr->states.data(), st_n * 4);
      memcpy(actions + b * ac_n, tr->actions.data(), ac_n * 4);
    }
    return 0;
  }

  double frames_decoded() const { return frames_.load(); }
  // returns a copy under the lock: workers write error_ under mu_, and
  // Python may poll vfi_error concurrently (a bare reference would race)
  std::string error() const {
    std::lock_guard<std::mutex> lk(mu_);
    return error_;
  }

 private:
  size_t traj_img_elems() const {
    return static_cast<size_t>(cfg_.T) * cfg_.ncam * cfg_.height * cfg_.width * 3;
  }

  // Worker: pull file indices, decode, push trajs into the pool.
  void worker_loop() {
    const bool dbg = getenv("VFI_DEBUG") != nullptr;
    while (true) {
      size_t order_pos = next_file_.fetch_add(1);
      size_t epoch = order_pos / cfg_.files.size();
      // Dead-dataset guard: only once every shard has actually been fully
      // scanned (files_scanned_) with zero trajectories pushed do we declare
      // the dataset unreadable.  Inferring from order_pos alone is racy:
      // with threads > files, a worker draws epoch >= 1 while its sibling is
      // still mid-decode on the first pass and total_pushed_ is legitimately
      // 0 — that worker must keep going (or hit the num_epochs exit below),
      // not poison the engine.
      if (epoch >= 1 && total_pushed_.load() == 0 &&
          files_scanned_.load() >= cfg_.files.size()) {
        std::lock_guard<std::mutex> lk(mu_);
        if (error_.empty())
          error_ = "no decodable trajectories in any input file "
                   "(shape/manifest mismatch or corrupt shards)" VFI_JPEG_NOTE;
        if (++workers_done_ == n_workers_) done_producing_ = true;
        cv_data_.notify_all();
        return;
      }
      if (cfg_.num_epochs > 0 &&
          epoch >= static_cast<size_t>(cfg_.num_epochs)) {
        std::lock_guard<std::mutex> lk(mu_);
        // n_workers_ is set before any thread spawns -- workers_.size()
        // would be a data race against the constructor's emplace loop
        if (++workers_done_ == n_workers_) done_producing_ = true;
        if (dbg)
          fprintf(stderr, "[vfi] worker exit, done=%d/%d\n", workers_done_,
                  n_workers_);
        cv_data_.notify_all();
        return;
      }
      const std::string& path =
          cfg_.files[file_order_[order_pos % cfg_.files.size()]];
      RecordStream rs(path);
      if (!rs.ok()) {
        files_scanned_.fetch_add(1);  // counts toward the dead-dataset guard
        std::lock_guard<std::mutex> lk(mu_);
        error_ = "cannot open " + path;
        continue;
      }
      if (dbg) fprintf(stderr, "[vfi] reading %s\n", path.c_str());
      std::string payload;
      int pushed = 0, rejected = 0;
      while (rs.next(&payload)) {
        auto tr = parse_traj(payload);
        if (!tr) {
          ++rejected;
          continue;
        }
        std::unique_lock<std::mutex> lk(mu_);
        cv_space_.wait(lk, [this] {
          return stop_ || static_cast<int>(pool_.size()) < cfg_.pool_size;
        });
        if (stop_) return;
        pool_.push_back(std::move(tr));
        ++pushed;
        total_pushed_.fetch_add(1);
        cv_data_.notify_one();
      }
      files_scanned_.fetch_add(1);
      if (dbg)
        fprintf(stderr, "[vfi] file done: pushed=%d rejected=%d\n", pushed,
                rejected);
      if (stop_) return;
    }
  }

  std::unique_ptr<Traj> parse_traj(const std::string& payload) {
    auto tr = std::make_unique<Traj>();
    tr->images.resize(traj_img_elems());
    tr->states.assign(static_cast<size_t>(cfg_.T) * cfg_.sdim, 0.f);
    tr->actions.assign(static_cast<size_t>(cfg_.T) * cfg_.adim, 0.f);
    const size_t frame_n = static_cast<size_t>(cfg_.height) * cfg_.width * 3;
    int hits = 0;
    Span root{reinterpret_cast<const uint8_t*>(payload.data()), payload.size()};
    bool ok = walk(root, [&](uint32_t f, uint32_t w, Span features, uint64_t) {
      if (f != 1 || w != 2) return;  // Example.features
      walk(features, [&](uint32_t f2, uint32_t w2, Span entry, uint64_t) {
        if (f2 != 1 || w2 != 2) return;  // map entry
        Span key{nullptr, 0}, feat{nullptr, 0};
        walk(entry, [&](uint32_t f3, uint32_t w3, Span v, uint64_t) {
          if (f3 == 1 && w3 == 2) key = v;
          else if (f3 == 2 && w3 == 2) feat = v;
        });
        if (!key.p || !feat.p) return;
        auto it = slots_.find(
            std::string(reinterpret_cast<const char*>(key.p), key.n));
        if (it == slots_.end()) return;
        const Slot& slot = it->second;
        if (slot.kind == Kind::kImage) {
          Span img;
          if (bytes_value(feat, &img) &&
              decode_image(img,
                           tr->images.data() +
                               (static_cast<size_t>(slot.t) * cfg_.ncam +
                                slot.cam) * frame_n,
                           cfg_.height, cfg_.width)) {
            ++hits;
            frames_.fetch_add(1);
          }
        } else if (slot.kind == Kind::kState) {
          float_values(feat, tr->states.data() +
                                 static_cast<size_t>(slot.t) * cfg_.sdim,
                       cfg_.sdim);
        } else {
          float_values(feat, tr->actions.data() +
                                 static_cast<size_t>(slot.t) * cfg_.adim,
                       cfg_.adim);
        }
      });
    });
    if (!ok || hits < cfg_.T * cfg_.ncam) return nullptr;  // incomplete traj
    return tr;
  }

  Config cfg_;
  std::unordered_map<std::string, Slot> slots_;
  std::vector<size_t> file_order_;
  std::vector<std::thread> workers_;
  int n_workers_ = 0;
  std::atomic<size_t> next_file_{0};
  std::atomic<size_t> files_scanned_{0};
  std::atomic<long long> frames_{0};
  std::atomic<long long> total_pushed_{0};

  mutable std::mutex mu_;
  std::condition_variable cv_data_, cv_space_;
  std::vector<std::unique_ptr<Traj>> pool_;
  std::mt19937 rng_;
  bool stop_ = false;
  bool done_producing_ = false;
  int workers_done_ = 0;
  std::string error_;
};

struct Handle {
  std::unique_ptr<Engine> engine;
  std::string error;
  std::string err_cache;  // stable storage for vfi_error's returned pointer
};

}  // namespace

extern "C" {

void* vfi_open(const char* config_text) {
  auto* h = new Handle;
  std::string err;
  Config cfg = parse_config(config_text, &err);
  if (!err.empty()) {
    h->error = err;
    return h;
  }
  h->engine = std::make_unique<Engine>(cfg);
  return h;
}

int vfi_next(void* vh, uint8_t* images, float* states, float* actions) {
  auto* h = static_cast<Handle*>(vh);
  if (!h->engine) return 2;
  return h->engine->next(images, states, actions);
}

double vfi_frames_decoded(void* vh) {
  auto* h = static_cast<Handle*>(vh);
  return h->engine ? h->engine->frames_decoded() : 0.0;
}

const char* vfi_error(void* vh) {
  auto* h = static_cast<Handle*>(vh);
  if (!h->error.empty()) return h->error.c_str();
  if (h->engine) {
    // Engine::error() returns a lock-guarded copy; park it in the handle so
    // the pointer stays valid after this call returns
    h->err_cache = h->engine->error();
    return h->err_cache.c_str();
  }
  return "";
}

void vfi_close(void* vh) { delete static_cast<Handle*>(vh); }

}  // extern "C"
