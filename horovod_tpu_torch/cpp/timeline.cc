// Native timeline writer: lock-free SPSC ring + dedicated writer thread
// (the port's copy of horovod_tpu/cpp/timeline.cc, with the same C ABI).
//
// The analogue of the reference's timeline machinery (reference:
// horovod/common/timeline.cc:28-127 TimelineWriter, timeline.h:66-75: a
// boost::lockfree::spsc_queue drained by a writer thread so the hot
// coordination path never blocks on file I/O). Records are packed into a
// fixed byte ring by the producer (the runtime cycle thread, which holds
// the Python-side timeline lock, so single-producer holds); the consumer
// thread formats Chrome-trace JSON and writes buffered.
//
// On ring overflow events are dropped and counted. The drop count is
// written as a final metadata record at close, zero included, so a reader
// can tell a complete trace from a truncated one.
//
// C API (ctypes):
//   void* hvd_tl_open(const char* path);
//   int   hvd_tl_emit(void* h, char ph, int pid, double ts_us,
//                     const char* name, const char* args_json,
//                     const char* s);   // returns 1 if dropped
//   void  hvd_tl_close(void* h);

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>

namespace {

constexpr size_t kRingBytes = 1 << 20;  // 1 MiB of in-flight events

struct Record {
  char ph;
  int32_t pid;
  double ts_us;
  // followed by: u16 name_len, name bytes, u16 args_len, args bytes,
  // u8 s_len, s bytes
};

class SpscRing {
 public:
  // Producer: copy `n` bytes in if they fit; false on overflow.
  bool push(const uint8_t* data, uint32_t n) {
    size_t head = head_.load(std::memory_order_relaxed);
    size_t tail = tail_.load(std::memory_order_acquire);
    size_t free_bytes = kRingBytes - (head - tail);
    if (n + 4 > free_bytes) return false;
    write_bytes(head, reinterpret_cast<const uint8_t*>(&n), 4);
    write_bytes(head + 4, data, n);
    head_.store(head + 4 + n, std::memory_order_release);
    return true;
  }

  // Consumer: pop one record into out (must hold kRingBytes); 0 if empty.
  uint32_t pop(uint8_t* out) {
    size_t tail = tail_.load(std::memory_order_relaxed);
    size_t head = head_.load(std::memory_order_acquire);
    if (head == tail) return 0;
    uint32_t n;
    read_bytes(tail, reinterpret_cast<uint8_t*>(&n), 4);
    read_bytes(tail + 4, out, n);
    tail_.store(tail + 4 + n, std::memory_order_release);
    return n;
  }

 private:
  void write_bytes(size_t pos, const uint8_t* src, size_t n) {
    size_t off = pos % kRingBytes;
    size_t first = std::min(n, kRingBytes - off);
    memcpy(buf_ + off, src, first);
    if (first < n) memcpy(buf_, src + first, n - first);
  }
  void read_bytes(size_t pos, uint8_t* dst, size_t n) {
    size_t off = pos % kRingBytes;
    size_t first = std::min(n, kRingBytes - off);
    memcpy(dst, buf_ + off, first);
    if (first < n) memcpy(dst + first, buf_, n - first);
  }

  alignas(64) std::atomic<size_t> head_{0};  // producer-owned
  alignas(64) std::atomic<size_t> tail_{0};  // consumer-owned
  uint8_t buf_[kRingBytes];
};

class TimelineFile {
 public:
  explicit TimelineFile(const char* path) {
    file_ = fopen(path, "w");
    if (!file_) return;
    fputs("[\n", file_);
    thread_ = std::thread([this] { run(); });
  }

  bool ok() const { return file_ != nullptr; }

  int emit(char ph, int pid, double ts_us, const char* name,
           const char* args_json, const char* s) {
    uint8_t rec[4096];
    size_t off = 0;
    Record hdr{ph, pid, ts_us};
    memcpy(rec + off, &hdr, sizeof(hdr));
    off += sizeof(hdr);
    // oversized records and ring overflow both count as drops, so the
    // close-time dropped_events total is honest either way
    if (!pack_str(rec, sizeof(rec), off, name, 2) ||
        !pack_str(rec, sizeof(rec), off, args_json, 2) ||
        !pack_str(rec, sizeof(rec), off, s, 1) ||
        !ring_.push(rec, static_cast<uint32_t>(off))) {
      dropped_.fetch_add(1, std::memory_order_relaxed);
      return 1;
    }
    return 0;
  }

  void close() {
    if (!file_) return;
    closing_.store(true, std::memory_order_release);
    if (thread_.joinable()) thread_.join();
    long dropped = dropped_.load(std::memory_order_relaxed);
    fprintf(file_,
            "{\"ph\":\"M\",\"pid\":0,\"name\":\"dropped_events\","
            "\"args\":{\"count\":%ld}},\n",
            dropped);
    fputs("{}]\n", file_);
    fclose(file_);
    file_ = nullptr;
  }

  ~TimelineFile() { close(); }

 private:
  static bool pack_str(uint8_t* rec, size_t cap, size_t& off,
                       const char* s, int len_bytes) {
    size_t n = s ? strlen(s) : 0;
    if (n > 0xFFFF) n = 0xFFFF;
    if (off + static_cast<size_t>(len_bytes) + n > cap) return false;
    if (len_bytes == 2) {
      uint16_t v = static_cast<uint16_t>(n);
      memcpy(rec + off, &v, 2);
      off += 2;
    } else {
      rec[off++] = static_cast<uint8_t>(n);
    }
    if (n) memcpy(rec + off, s, n);
    off += n;
    return true;
  }

  void run() {
    uint8_t rec[4096];
    std::string line;
    while (true) {
      uint32_t n = ring_.pop(rec);
      if (n == 0) {
        if (closing_.load(std::memory_order_acquire)) {
          // one final drain so no event races the shutdown flag
          n = ring_.pop(rec);
          if (n == 0) break;
        } else {
          std::this_thread::sleep_for(std::chrono::microseconds(500));
          continue;
        }
      }
      format(rec, line);
      fwrite(line.data(), 1, line.size(), file_);
    }
    fflush(file_);
  }

  void format(const uint8_t* rec, std::string& line) {
    Record hdr;
    memcpy(&hdr, rec, sizeof(hdr));
    size_t off = sizeof(hdr);
    auto take2 = [&](void) {
      uint16_t n;
      memcpy(&n, rec + off, 2);
      off += 2;
      const char* p = reinterpret_cast<const char*>(rec + off);
      off += n;
      return std::string(p, n);
    };
    std::string name = take2();
    std::string args = take2();
    uint8_t slen = rec[off++];
    std::string s(reinterpret_cast<const char*>(rec + off), slen);

    // ts is printed as integer-microseconds.fraction by hand: %.3f would
    // follow LC_NUMERIC and emit a decimal comma under some locales,
    // producing invalid JSON.
    long long ts_ns = static_cast<long long>(hdr.ts_us * 1000.0 + 0.5);
    char head[96];
    snprintf(head, sizeof(head),
             "{\"ph\":\"%c\",\"pid\":%d,\"ts\":%lld.%03lld", hdr.ph,
             hdr.pid, ts_ns / 1000, ts_ns % 1000);
    line.assign(head);
    if (!name.empty()) {
      line += ",\"name\":\"";
      append_escaped(line, name);
      line += '"';
    }
    if (!args.empty()) {
      line += ",\"args\":";
      line += args;  // caller-provided JSON, passed through
    }
    if (!s.empty()) {
      line += ",\"s\":\"";
      append_escaped(line, s);
      line += '"';
    }
    line += "},\n";
  }

  static void append_escaped(std::string& out, const std::string& in) {
    for (char c : in) {
      if (c == '"' || c == '\\') {
        out += '\\';
        out += c;
      } else if (static_cast<unsigned char>(c) < 0x20) {
        char buf[8];
        snprintf(buf, sizeof(buf), "\\u%04x", c);
        out += buf;
      } else {
        out += c;
      }
    }
  }

  FILE* file_ = nullptr;
  SpscRing ring_;
  std::thread thread_;
  std::atomic<bool> closing_{false};
  std::atomic<long> dropped_{0};
};

}  // namespace

extern "C" {

void* hvd_tl_open(const char* path) {
  auto* t = new TimelineFile(path);
  if (!t->ok()) {
    delete t;
    return nullptr;
  }
  return t;
}

int hvd_tl_emit(void* h, char ph, int pid, double ts_us, const char* name,
                const char* args_json, const char* s) {
  return static_cast<TimelineFile*>(h)->emit(ph, pid, ts_us, name,
                                             args_json, s);
}

void hvd_tl_close(void* h) {
  auto* t = static_cast<TimelineFile*>(h);
  t->close();
  delete t;
}

}  // extern "C"
