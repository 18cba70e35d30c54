// Camera streaming node.
//
// Native re-implementation of the capability of the reference's ROS camera
// publisher (visual_mpc/foresight_rospkg/src/video_stream.cpp:92-296): a
// capture thread reads frames from a V4L2 device (YUYV) or a synthetic test
// pattern and pushes them into a mutex-guarded bounded queue (drop-oldest);
// the main loop throttles to the requested fps, applies optional flips, and
// publishes into a POSIX shared-memory ring (see shm_ring.h) consumed by the
// Python CameraRecorder when ROS is absent.
//
// The port's copy of visual_foresight_tpu/native/camera_stream.cpp: the
// shared-memory name, layout and magic (shm_ring.h) are kept, so that a node
// of either package feeds a client of either package.
//
// Build: visual_foresight_torch/ops/_build.py::build_host_executable (g++,
// into build/native/ at the root of the checkout, at first use).
// Usage: camera_stream --channel cam0 [--device /dev/video0 | --test-pattern]
//                      [--width 640 --height 480 --fps 30]
//                      [--flip-h] [--flip-v]

#include <fcntl.h>
#include <linux/videodev2.h>
#include <string.h>
#include <sys/ioctl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include "shm_ring.h"

namespace {

using Clock = std::chrono::steady_clock;

double now_seconds() {
  return std::chrono::duration<double>(
             std::chrono::system_clock::now().time_since_epoch())
      .count();
}

struct Frame {
  std::vector<uint8_t> rgb;  // H*W*3
  double timestamp;
};

// Bounded drop-oldest frame queue (same policy as the reference's capture
// thread: the consumer must never see stale frames pile up).
class FrameQueue {
 public:
  explicit FrameQueue(size_t max_size) : max_size_(max_size) {}

  void push(Frame&& f) {
    std::lock_guard<std::mutex> lock(mu_);
    if (q_.size() >= max_size_) q_.pop();  // drop oldest
    q_.push(std::move(f));
    cv_.notify_one();
  }

  bool pop(Frame* out, double timeout_s) {
    std::unique_lock<std::mutex> lock(mu_);
    if (!cv_.wait_for(lock, std::chrono::duration<double>(timeout_s),
                      [&] { return !q_.empty(); }))
      return false;
    *out = std::move(q_.front());
    q_.pop();
    return true;
  }

 private:
  std::mutex mu_;
  std::condition_variable cv_;
  std::queue<Frame> q_;
  size_t max_size_;
};

// ---------------------------------------------------------------- sources
class FrameSource {
 public:
  virtual ~FrameSource() = default;
  virtual bool read(Frame* f) = 0;
  virtual int width() const = 0;
  virtual int height() const = 0;
};

// Synthetic moving-gradient source for tests / bring-up without hardware.
class TestPatternSource : public FrameSource {
 public:
  TestPatternSource(int w, int h, double fps) : w_(w), h_(h), period_(1.0 / fps) {}

  bool read(Frame* f) override {
    std::this_thread::sleep_for(std::chrono::duration<double>(period_));
    f->rgb.resize(static_cast<size_t>(w_) * h_ * 3);
    int t = counter_++;
    for (int r = 0; r < h_; ++r) {
      for (int c = 0; c < w_; ++c) {
        size_t i = (static_cast<size_t>(r) * w_ + c) * 3;
        f->rgb[i + 0] = static_cast<uint8_t>((r + t * 3) & 0xFF);
        f->rgb[i + 1] = static_cast<uint8_t>((c + t * 5) & 0xFF);
        f->rgb[i + 2] = static_cast<uint8_t>((r + c + t) & 0xFF);
      }
    }
    f->timestamp = now_seconds();
    return true;
  }
  int width() const override { return w_; }
  int height() const override { return h_; }

 private:
  int w_, h_;
  double period_;
  int counter_ = 0;
};

inline uint8_t clamp_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// V4L2 capture in YUYV with mmap'ed buffers.
class V4L2Source : public FrameSource {
 public:
  V4L2Source(const std::string& device, int w, int h) : w_(w), h_(h) {
    fd_ = open(device.c_str(), O_RDWR);
    if (fd_ < 0) {
      perror("open video device");
      exit(1);
    }
    v4l2_format fmt = {};
    fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    fmt.fmt.pix.width = w_;
    fmt.fmt.pix.height = h_;
    fmt.fmt.pix.pixelformat = V4L2_PIX_FMT_YUYV;
    fmt.fmt.pix.field = V4L2_FIELD_NONE;
    if (ioctl(fd_, VIDIOC_S_FMT, &fmt) < 0) {
      perror("VIDIOC_S_FMT");
      exit(1);
    }
    w_ = fmt.fmt.pix.width;
    h_ = fmt.fmt.pix.height;

    v4l2_requestbuffers req = {};
    req.count = 4;
    req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    req.memory = V4L2_MEMORY_MMAP;
    if (ioctl(fd_, VIDIOC_REQBUFS, &req) < 0) {
      perror("VIDIOC_REQBUFS");
      exit(1);
    }
    for (unsigned i = 0; i < req.count; ++i) {
      v4l2_buffer buf = {};
      buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
      buf.memory = V4L2_MEMORY_MMAP;
      buf.index = i;
      if (ioctl(fd_, VIDIOC_QUERYBUF, &buf) < 0) {
        perror("VIDIOC_QUERYBUF");
        exit(1);
      }
      void* ptr = mmap(nullptr, buf.length, PROT_READ | PROT_WRITE,
                       MAP_SHARED, fd_, buf.m.offset);
      buffers_.push_back({ptr, buf.length});
      ioctl(fd_, VIDIOC_QBUF, &buf);
    }
    v4l2_buf_type type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    ioctl(fd_, VIDIOC_STREAMON, &type);
  }

  bool read(Frame* f) override {
    v4l2_buffer buf = {};
    buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE;
    buf.memory = V4L2_MEMORY_MMAP;
    if (ioctl(fd_, VIDIOC_DQBUF, &buf) < 0) return false;
    f->timestamp = now_seconds();
    f->rgb.resize(static_cast<size_t>(w_) * h_ * 3);
    yuyv_to_rgb(static_cast<uint8_t*>(buffers_[buf.index].first),
                f->rgb.data());
    ioctl(fd_, VIDIOC_QBUF, &buf);
    return true;
  }

  int width() const override { return w_; }
  int height() const override { return h_; }

 private:
  void yuyv_to_rgb(const uint8_t* yuyv, uint8_t* rgb) const {
    for (int i = 0; i < w_ * h_ / 2; ++i) {
      int y0 = yuyv[i * 4 + 0], u = yuyv[i * 4 + 1] - 128;
      int y1 = yuyv[i * 4 + 2], v = yuyv[i * 4 + 3] - 128;
      for (int k = 0; k < 2; ++k) {
        int y = (k == 0 ? y0 : y1);
        rgb[i * 6 + k * 3 + 0] = clamp_u8(y + (91881 * v >> 16));
        rgb[i * 6 + k * 3 + 1] =
            clamp_u8(y - ((22554 * u + 46802 * v) >> 16));
        rgb[i * 6 + k * 3 + 2] = clamp_u8(y + (116130 * u >> 16));
      }
    }
  }

  int fd_ = -1, w_, h_;
  std::vector<std::pair<void*, size_t>> buffers_;
};

// ---------------------------------------------------------------- publisher
class ShmPublisher {
 public:
  ShmPublisher(const std::string& channel, int w, int h, int n_slots = 8) {
    std::string name = "/vftpu_cam_" + channel;
    shm_unlink(name.c_str());
    int fd = shm_open(name.c_str(), O_CREAT | O_RDWR, 0666);
    if (fd < 0) {
      perror("shm_open");
      exit(1);
    }
    vftpu::ShmHeader tmp = {};
    tmp.width = w;
    tmp.height = h;
    tmp.channels = 3;
    tmp.n_slots = n_slots;
    tmp.frame_bytes = static_cast<uint64_t>(w) * h * 3;
    size_t size = vftpu::total_size(tmp);
    if (ftruncate(fd, size) < 0) {
      perror("ftruncate");
      exit(1);
    }
    base_ = static_cast<uint8_t*>(
        mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0));
    close(fd);
    header_ = reinterpret_cast<vftpu::ShmHeader*>(base_);
    *header_ = tmp;
    header_->write_counter = 0;
    // publish magic last so readers never see a half-built header
    header_->version = vftpu::kShmVersion;
    std::atomic_thread_fence(std::memory_order_release);
    header_->magic = vftpu::kShmMagic;
    fprintf(stderr, "publishing %dx%d on shm %s\n", w, h, name.c_str());
  }

  void publish(const Frame& f) {
    uint64_t idx = header_->write_counter % header_->n_slots;
    uint8_t* slot = base_ + sizeof(vftpu::ShmHeader) +
                    idx * vftpu::slot_stride(*header_);
    auto* sh = reinterpret_cast<vftpu::SlotHeader*>(slot);
    sh->seq += 1;  // odd: write in progress
    std::atomic_thread_fence(std::memory_order_release);
    memcpy(slot + sizeof(vftpu::SlotHeader), f.rgb.data(), f.rgb.size());
    sh->timestamp = f.timestamp;
    std::atomic_thread_fence(std::memory_order_release);
    sh->seq += 1;  // even: stable
    std::atomic_thread_fence(std::memory_order_release);
    header_->write_counter += 1;
  }

 private:
  uint8_t* base_;
  vftpu::ShmHeader* header_;
};

void flip_frame(Frame* f, int w, int h, bool flip_h, bool flip_v) {
  if (!flip_h && !flip_v) return;
  std::vector<uint8_t> out(f->rgb.size());
  for (int r = 0; r < h; ++r) {
    int rr = flip_v ? h - 1 - r : r;
    for (int c = 0; c < w; ++c) {
      int cc = flip_h ? w - 1 - c : c;
      memcpy(&out[(static_cast<size_t>(r) * w + c) * 3],
             &f->rgb[(static_cast<size_t>(rr) * w + cc) * 3], 3);
    }
  }
  f->rgb.swap(out);
}

}  // namespace

int main(int argc, char** argv) {
  std::string channel = "cam0", device;
  int width = 640, height = 480;
  double fps = 30.0;
  bool test_pattern = false, flip_h = false, flip_v = false;
  int max_frames = -1;  // for tests

  for (int i = 1; i < argc; ++i) {
    std::string arg = argv[i];
    auto next = [&](const char* what) -> std::string {
      if (i + 1 >= argc) {
        fprintf(stderr, "missing value for %s\n", what);
        exit(2);
      }
      return argv[++i];
    };
    if (arg == "--channel") channel = next("--channel");
    else if (arg == "--device") device = next("--device");
    else if (arg == "--width") width = atoi(next("--width").c_str());
    else if (arg == "--height") height = atoi(next("--height").c_str());
    else if (arg == "--fps") fps = atof(next("--fps").c_str());
    else if (arg == "--test-pattern") test_pattern = true;
    else if (arg == "--flip-h") flip_h = true;
    else if (arg == "--flip-v") flip_v = true;
    else if (arg == "--max-frames") max_frames = atoi(next("--max-frames").c_str());
    else {
      fprintf(stderr, "unknown arg %s\n", arg.c_str());
      return 2;
    }
  }

  std::unique_ptr<FrameSource> source;
  if (test_pattern || device.empty()) {
    source = std::make_unique<TestPatternSource>(width, height, fps * 2);
  } else {
    source = std::make_unique<V4L2Source>(device, width, height);
  }

  FrameQueue queue(4);
  std::atomic<bool> running{true};

  std::thread capture([&] {
    Frame f;
    while (running.load()) {
      if (source->read(&f)) queue.push(std::move(f));
    }
  });

  ShmPublisher pub(channel, source->width(), source->height());
  const auto frame_period = std::chrono::duration<double>(1.0 / fps);
  auto next_pub = Clock::now();
  int published = 0;

  Frame f;
  while (max_frames < 0 || published < max_frames) {
    if (!queue.pop(&f, 5.0)) {
      fprintf(stderr, "no frames for 5s — capture stalled\n");
      continue;
    }
    std::this_thread::sleep_until(next_pub);  // throttle to fps
    next_pub = Clock::now() + std::chrono::duration_cast<Clock::duration>(
                                  frame_period);
    flip_frame(&f, source->width(), source->height(), flip_h, flip_v);
    pub.publish(f);
    ++published;
  }

  running.store(false);
  capture.join();
  return 0;
}
