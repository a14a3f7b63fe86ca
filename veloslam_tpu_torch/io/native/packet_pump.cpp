// Host-side packet pump: pcap bulk parse + UDP receive/replay.
//
// Native equivalent of the reference's packet plane — vtkPacketFileReader
// (pcap open/filter/strip, vtkPacketFileReader.h:87-197), vtkPacketFileWriter
// (canned 42-byte headers, vtkPacketFileWriter.cxx:41-161), the asio
// receiver stack (HDLSource.cxx:365-506) and the pcap replayer
// (vvPacketSender.cxx:82-111, PacketFileSender.cxx:41-89) — reimplemented
// with no libpcap/boost dependency: the pcap container format is parsed
// directly and sockets are plain POSIX UDP.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  All bulk data
// moves through caller-allocated numpy buffers; the receiver runs a
// background thread into a ring buffer, mirroring the reference's
// receiver-thread + SynchronizedQueue design (HDLSource.cxx:47-128) without
// per-packet allocation.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// pcap bulk parse
// ---------------------------------------------------------------------------

// Parse a pcap file, copying UDP payloads of exactly `payload_size` bytes
// into `out` (shape [max_packets, payload_size]) and their record times
// (µs) into `out_times`.  Returns the number of packets written, or -1 on
// error.  `*file_offsets` (optional) receives each record's byte offset for
// random re-reads (the reference's fpos index, HDLParser.cxx:1065-1160).
long long pp_read_packets(const char* path, int payload_size,
                          unsigned char* out, long long* out_times,
                          long long* file_offsets, long long max_packets) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char gh[24];
  if (fread(gh, 1, 24, f) != 24) { fclose(f); return -1; }
  uint32_t magic;
  memcpy(&magic, gh, 4);
  int t_div = 1;
  if (magic == 0xa1b2c3d4u) t_div = 1;
  else if (magic == 0xa1b23c4du) t_div = 1000;   // nanosecond pcap
  else { fclose(f); return -1; }

  const int kHdr = 42;  // Ethernet + IPv4 + UDP framing
  long long n = 0;
  std::vector<unsigned char> buf(65536 + 64);
  while (n < max_packets) {
    long long off = ftell(f);
    unsigned char rh[16];
    if (fread(rh, 1, 16, f) != 16) break;
    uint32_t sec, frac, incl;
    memcpy(&sec, rh, 4);
    memcpy(&frac, rh + 4, 4);
    memcpy(&incl, rh + 8, 4);
    if (incl > buf.size()) { fclose(f); return -1; }
    if (fread(buf.data(), 1, incl, f) != incl) break;
    if ((int)incl != kHdr + payload_size) continue;
    if (buf[23] != 17) continue;                  // not UDP
    memcpy(out + n * payload_size, buf.data() + kHdr, payload_size);
    out_times[n] = (long long)sec * 1000000LL + (long long)(frac / t_div);
    if (file_offsets) file_offsets[n] = off;
    n++;
  }
  fclose(f);
  return n;
}

// Count matching packets without copying (for pre-allocation).
long long pp_count_packets(const char* path, int payload_size) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  unsigned char gh[24];
  if (fread(gh, 1, 24, f) != 24) { fclose(f); return -1; }
  const int kHdr = 42;
  long long n = 0;
  unsigned char rh[16];
  while (fread(rh, 1, 16, f) == 16) {
    uint32_t incl;
    memcpy(&incl, rh + 8, 4);
    long long pos = ftell(f);
    unsigned char proto = 0;
    if (incl > 23) {
      if (fseek(f, 23, SEEK_CUR) != 0) break;
      if (fread(&proto, 1, 1, f) != 1) break;
    }
    if ((int)incl == kHdr + payload_size && proto == 17) n++;
    if (fseek(f, pos + incl, SEEK_SET) != 0) break;
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// pcap write
// ---------------------------------------------------------------------------

// Write `n` payloads as a pcap with synthetic Ethernet/IPv4/UDP headers
// (dport selected like the reference: 2368 for 1206-byte LiDAR payloads,
// 8308 otherwise — vtkPacketFileWriter.cxx:41-54).
long long pp_write_pcap(const char* path, const unsigned char* payloads,
                        const long long* times_us, long long n,
                        int payload_size, int dport) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const unsigned char gh[24] = {0xd4, 0xc3, 0xb2, 0xa1, 2, 0, 4, 0,
                                0, 0, 0, 0, 0, 0, 0, 0,
                                0xff, 0xff, 0, 0, 1, 0, 0, 0};
  fwrite(gh, 1, 24, f);
  const int kHdr = 42;
  std::vector<unsigned char> pkt(kHdr + payload_size);
  // Ethernet
  memset(pkt.data(), 0xff, 6);
  const unsigned char srcmac[6] = {0x60, 0x76, 0x88, 0, 0, 0};
  memcpy(pkt.data() + 6, srcmac, 6);
  pkt[12] = 0x08; pkt[13] = 0x00;
  // IPv4
  uint16_t total = 20 + 8 + payload_size;
  pkt[14] = 0x45; pkt[15] = 0;
  pkt[16] = total >> 8; pkt[17] = total & 0xff;
  pkt[18] = 0x04; pkt[19] = 0xd2;
  pkt[20] = 0x40; pkt[21] = 0x00;
  pkt[22] = 0xff; pkt[23] = 17;
  pkt[24] = 0; pkt[25] = 0;  // checksum unset
  const unsigned char src_ip[4] = {192, 168, 1, 201};
  const unsigned char dst_ip[4] = {255, 255, 255, 255};
  memcpy(pkt.data() + 26, src_ip, 4);
  memcpy(pkt.data() + 30, dst_ip, 4);
  // UDP
  uint16_t ulen = 8 + payload_size;
  pkt[34] = dport >> 8; pkt[35] = dport & 0xff;
  pkt[36] = dport >> 8; pkt[37] = dport & 0xff;
  pkt[38] = ulen >> 8; pkt[39] = ulen & 0xff;
  pkt[40] = 0; pkt[41] = 0;

  for (long long i = 0; i < n; i++) {
    uint32_t sec = (uint32_t)(times_us[i] / 1000000LL);
    uint32_t usec = (uint32_t)(times_us[i] % 1000000LL);
    uint32_t len = kHdr + payload_size;
    unsigned char rh[16];
    memcpy(rh, &sec, 4);
    memcpy(rh + 4, &usec, 4);
    memcpy(rh + 8, &len, 4);
    memcpy(rh + 12, &len, 4);
    fwrite(rh, 1, 16, f);
    memcpy(pkt.data() + kHdr, payloads + i * payload_size, payload_size);
    fwrite(pkt.data(), 1, pkt.size(), f);
  }
  fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// UDP receiver (background thread + ring buffer)
// ---------------------------------------------------------------------------

struct Receiver {
  int fd = -1;
  int payload_size = 0;   // slot size; in exact mode also the size filter
  int exact = 1;          // 0: accept any datagram <= payload_size
  long long capacity = 0;
  std::vector<unsigned char> ring;
  std::vector<long long> times;
  std::vector<int> lens;  // actual datagram length per slot
  std::atomic<long long> head{0};   // next write slot (monotonic)
  std::atomic<long long> tail{0};   // next read slot  (monotonic)
  std::atomic<long long> dropped{0};
  std::atomic<bool> stop{false};
  std::thread thread;
  std::mutex mu;
};

static long long now_us() {
  struct timeval tv;
  gettimeofday(&tv, nullptr);
  return (long long)tv.tv_sec * 1000000LL + tv.tv_usec;
}

static void* udp_open_impl(int port, int payload_size, long long capacity,
                           int exact) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  int rcvbuf = 8 * 1024 * 1024;
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  struct timeval tv = {0, 100000};  // 100 ms poll so stop is responsive
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons((uint16_t)port);
  if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0) { close(fd); return nullptr; }

  auto* r = new Receiver();
  r->fd = fd;
  r->payload_size = payload_size;
  r->exact = exact;
  r->capacity = capacity;
  r->ring.resize(capacity * payload_size);
  r->times.resize(capacity);
  r->lens.resize(capacity);
  r->thread = std::thread([r]() {
    std::vector<unsigned char> buf(65536);
    while (!r->stop.load()) {
      ssize_t got = recv(r->fd, buf.data(), buf.size(), 0);
      if (got <= 0) continue;                          // timeout/error
      if (r->exact ? (got != (ssize_t)r->payload_size)
                   : (got > (ssize_t)r->payload_size))
        continue;                                      // wrong/oversize
      // Single-producer/single-consumer ring: the producer writes only
      // `head`, the consumer writes only `tail`.  On overflow the NEW
      // datagram is dropped — advancing `tail` from here (drop-oldest)
      // would both race the consumer's tail update and overwrite the
      // slot it may be mid-read (a torn packet; found by the TSAN
      // harness, tests/native_tsan_main.cpp).
      long long h = r->head.load(std::memory_order_relaxed);
      if (h - r->tail.load(std::memory_order_acquire) >= r->capacity) {
        r->dropped.fetch_add(1, std::memory_order_relaxed);
        continue;                                      // ring full
      }
      long long slot = h % r->capacity;
      unsigned char* dst = r->ring.data() + slot * r->payload_size;
      memcpy(dst, buf.data(), got);
      if (got < (ssize_t)r->payload_size)
        memset(dst + got, 0, r->payload_size - got);   // zero-pad the slot
      r->times[slot] = now_us();
      r->lens[slot] = (int)got;
      r->head.store(h + 1, std::memory_order_release);  // publish the slot
    }
  });
  return r;
}

void* pp_udp_open(int port, int payload_size, long long capacity) {
  return udp_open_impl(port, payload_size, capacity, /*exact=*/1);
}

// Variable-size variant: accepts any datagram up to slot_size bytes.
void* pp_udp_open_any(int port, int slot_size, long long capacity) {
  return udp_open_impl(port, slot_size, capacity, /*exact=*/0);
}

// Drain up to max_packets into out/out_times; returns the count.
long long pp_udp_poll(void* handle, unsigned char* out, long long* out_times,
                      long long max_packets) {
  auto* r = (Receiver*)handle;
  long long n = 0;
  while (n < max_packets) {
    long long t = r->tail.load(std::memory_order_relaxed);
    if (t >= r->head.load(std::memory_order_acquire)) break;
    long long slot = t % r->capacity;
    memcpy(out + n * r->payload_size,
           r->ring.data() + slot * r->payload_size, r->payload_size);
    out_times[n] = r->times[slot];
    r->tail.store(t + 1, std::memory_order_release);   // free the slot
    n++;
  }
  return n;
}

// Poll variant that also reports each datagram's actual length (for
// variable-size receivers, e.g. the mixed-message INS port).
long long pp_udp_poll_lens(void* handle, unsigned char* out,
                           long long* out_times, int* out_lens,
                           long long max_packets) {
  auto* r = (Receiver*)handle;
  long long n = 0;
  while (n < max_packets) {
    long long t = r->tail.load(std::memory_order_relaxed);
    if (t >= r->head.load(std::memory_order_acquire)) break;
    long long slot = t % r->capacity;
    memcpy(out + n * r->payload_size,
           r->ring.data() + slot * r->payload_size, r->payload_size);
    out_times[n] = r->times[slot];
    out_lens[n] = r->lens[slot];
    r->tail.store(t + 1, std::memory_order_release);   // free the slot
    n++;
  }
  return n;
}

long long pp_udp_dropped(void* handle) {
  return ((Receiver*)handle)->dropped.load();
}

void pp_udp_close(void* handle) {
  auto* r = (Receiver*)handle;
  r->stop.store(true);
  if (r->thread.joinable()) r->thread.join();
  close(r->fd);
  delete r;
}

// ---------------------------------------------------------------------------
// UDP replay (paced sender)
// ---------------------------------------------------------------------------

// Send n payloads to dest_ip:port with pace_us microseconds between sends
// (the reference replayer paces at 200 µs, PacketFileSender.cxx:78).
// Returns packets sent or -1.
long long pp_udp_send(const char* dest_ip, int port,
                      const unsigned char* payloads, long long n,
                      int payload_size, long long pace_us) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons((uint16_t)port);
  if (inet_pton(AF_INET, dest_ip, &addr.sin_addr) != 1) {
    close(fd);
    return -1;
  }
  long long sent = 0;
  for (long long i = 0; i < n; i++) {
    ssize_t w = sendto(fd, payloads + i * payload_size, payload_size, 0,
                       (sockaddr*)&addr, sizeof(addr));
    if (w == (ssize_t)payload_size) sent++;
    if (pace_us > 0)
      std::this_thread::sleep_for(std::chrono::microseconds(pace_us));
  }
  close(fd);
  return sent;
}

}  // extern "C"
