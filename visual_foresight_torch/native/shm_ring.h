// Shared-memory frame ring buffer layout, shared between the C++ camera
// node (camera_stream.cpp) and the Python client (camera_client.py).
//
// Replaces the ROS pub/sub transport of the reference's camera node
// (visual_mpc/foresight_rospkg/src/video_stream.cpp): frames are published
// into a POSIX shm ring with per-slot sequence numbers (seqlock) so readers
// detect torn frames without locks in the hot path.
//
// The port's copy of visual_foresight_tpu/native/shm_ring.h, byte for byte
// the same layout: either package's node feeds either package's client.
#pragma once
#include <cstdint>

namespace vftpu {

constexpr uint32_t kShmMagic = 0x56465450;  // "VFTP"
constexpr uint32_t kShmVersion = 1;

struct ShmHeader {
  uint32_t magic;
  uint32_t version;
  uint32_t width;
  uint32_t height;
  uint32_t channels;      // always 3 (RGB)
  uint32_t n_slots;
  uint64_t frame_bytes;   // width*height*channels
  // monotonically increasing count of completed frame writes; the latest
  // frame lives in slot (write_counter - 1) % n_slots
  volatile uint64_t write_counter;
};

struct SlotHeader {
  // seq is odd while the writer is mid-copy (seqlock); readers retry
  volatile uint64_t seq;
  double timestamp;       // seconds since epoch
};

inline uint64_t slot_stride(const ShmHeader& h) {
  return sizeof(SlotHeader) + h.frame_bytes;
}

inline uint64_t total_size(const ShmHeader& h) {
  return sizeof(ShmHeader) + h.n_slots * slot_stride(h);
}

}  // namespace vftpu
