// Native IO runtime for unified_cvo_tpu: npy parsing (the cnpy twin,
// reference thirdparty/cnpy/cnpy.cpp used by TartanAirHandler), raw velodyne
// .bin reading (reference KittiHandler::read_next_lidar), and a threaded
// prefetch executor that overlaps disk IO with device compute (the reference's
// data path is synchronous C++; apps here double-buffer through this loader).
//
// Plain C ABI consumed via ctypes (unified_cvo_tpu/native/__init__.py).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Blob {
  std::vector<char> data;      // raw element bytes (C-order)
  int64_t shape[8] = {0};
  int ndim = 0;
  char dtype = 0;              // 'f' f32, 'd' f64, 'u' u8, 'q' i64, 'h' i16
  int ok = 0;
};

bool read_file(const std::string& path, std::vector<char>& out) {
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = n ? std::fread(out.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

// Minimal .npy v1/v2 parser: little-endian, C-order arrays of
// f4/f8/u1/i8/i2 (the types TartanAir/semantic-KITTI files use).
bool parse_npy(const std::vector<char>& raw, Blob& b) {
  if (raw.size() < 10 || std::memcmp(raw.data(), "\x93NUMPY", 6) != 0)
    return false;
  uint8_t major = static_cast<uint8_t>(raw[6]);
  size_t hlen, hoff;
  if (major == 1) {
    hlen = static_cast<uint8_t>(raw[8]) | (static_cast<uint8_t>(raw[9]) << 8);
    hoff = 10;
  } else {
    if (raw.size() < 12) return false;
    hlen = static_cast<uint8_t>(raw[8]) | (static_cast<uint8_t>(raw[9]) << 8) |
           (static_cast<uint8_t>(raw[10]) << 16) |
           (static_cast<uint8_t>(raw[11]) << 24);
    hoff = 12;
  }
  if (raw.size() < hoff + hlen) return false;
  std::string hdr(raw.data() + hoff, hlen);

  auto find_val = [&](const char* key) -> std::string {
    size_t p = hdr.find(key);
    if (p == std::string::npos) return "";
    p = hdr.find(':', p);
    if (p == std::string::npos) return "";
    return hdr.substr(p + 1);
  };
  std::string descr = find_val("'descr'");
  size_t q1 = descr.find('\'');
  size_t q2 = descr.find('\'', q1 + 1);
  if (q1 == std::string::npos || q2 == std::string::npos) return false;
  std::string dt = descr.substr(q1 + 1, q2 - q1 - 1);
  if (dt.size() < 3) return false;
  char endian = dt[0];
  if (endian == '>') return false;  // big-endian unsupported
  std::string code = dt.substr(1);
  size_t esz;
  if (code == "f4") { b.dtype = 'f'; esz = 4; }
  else if (code == "f8") { b.dtype = 'd'; esz = 8; }
  else if (code == "u1") { b.dtype = 'u'; esz = 1; }
  else if (code == "i8") { b.dtype = 'q'; esz = 8; }
  else if (code == "i2") { b.dtype = 'h'; esz = 2; }
  else return false;

  std::string fo = find_val("'fortran_order'");
  if (fo.find("True") != std::string::npos) return false;

  size_t sp = hdr.find("'shape'");
  size_t l = hdr.find('(', sp), r = hdr.find(')', sp);
  if (l == std::string::npos || r == std::string::npos) return false;
  std::string shp = hdr.substr(l + 1, r - l - 1);
  b.ndim = 0;
  size_t total = 1;
  const char* s = shp.c_str();
  while (*s && b.ndim < 8) {
    while (*s == ' ' || *s == ',') ++s;
    if (!*s) break;
    int64_t v = std::strtoll(s, const_cast<char**>(&s), 10);
    b.shape[b.ndim++] = v;
    total *= static_cast<size_t>(v);
  }
  if (b.ndim == 0) { b.ndim = 1; b.shape[0] = 1; }
  size_t nbytes = total * esz;
  if (raw.size() < hoff + hlen + nbytes) return false;
  b.data.assign(raw.begin() + hoff + hlen, raw.begin() + hoff + hlen + nbytes);
  b.ok = 1;
  return true;
}

std::unique_ptr<Blob> load_path(const std::string& path, int kind) {
  auto b = std::make_unique<Blob>();
  std::vector<char> raw;
  if (!read_file(path, raw)) return b;
  if (kind == 1) {  // npy
    parse_npy(raw, *b);
  } else {          // raw little-endian f32 (velodyne .bin etc.)
    b->dtype = 'f';
    b->ndim = 1;
    b->shape[0] = static_cast<int64_t>(raw.size() / 4);
    b->data = std::move(raw);
    b->data.resize((b->data.size() / 4) * 4);
    b->ok = 1;
  }
  return b;
}

// ---- prefetch executor ----

struct Loader {
  struct Task {
    int64_t ticket;
    std::string path;
    int kind;
  };
  std::vector<std::thread> workers;
  std::deque<Task> queue;
  std::unordered_map<int64_t, std::unique_ptr<Blob>> done;
  std::mutex mu;
  std::condition_variable cv_task, cv_done;
  std::atomic<int64_t> next_ticket{1};
  bool stop = false;

  explicit Loader(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] { run(); });
  }
  ~Loader() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv_task.notify_all();
    for (auto& w : workers) w.join();
  }
  void run() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> g(mu);
        cv_task.wait(g, [&] { return stop || !queue.empty(); });
        if (stop && queue.empty()) return;
        t = std::move(queue.front());
        queue.pop_front();
      }
      auto blob = load_path(t.path, t.kind);
      {
        std::lock_guard<std::mutex> g(mu);
        done[t.ticket] = std::move(blob);
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* cvo_loader_create(int n_workers) {
  return new Loader(n_workers > 0 ? n_workers : 2);
}

void cvo_loader_destroy(void* h) { delete static_cast<Loader*>(h); }

// enqueue a read; kind: 0 = raw f32, 1 = npy. Returns a ticket.
int64_t cvo_loader_submit(void* h, const char* path, int kind) {
  auto* L = static_cast<Loader*>(h);
  int64_t tk = L->next_ticket.fetch_add(1);
  {
    std::lock_guard<std::mutex> g(L->mu);
    L->queue.push_back({tk, path, kind});
  }
  L->cv_task.notify_one();
  return tk;
}

// Block until the ticket is ready; fills ndim/shape/dtype; returns total
// byte count (0 = read/parse failure). Data stays owned by the loader until
// cvo_loader_fetch + release.
int64_t cvo_loader_wait(void* h, int64_t ticket, int* ndim, int64_t* shape,
                        char* dtype) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> g(L->mu);
  L->cv_done.wait(g, [&] { return L->done.count(ticket) > 0; });
  Blob* b = L->done[ticket].get();
  if (!b->ok) return 0;
  *ndim = b->ndim;
  for (int i = 0; i < b->ndim; ++i) shape[i] = b->shape[i];
  *dtype = b->dtype;
  return static_cast<int64_t>(b->data.size());
}

// Copy the blob's bytes out and release it.
int cvo_loader_fetch(void* h, int64_t ticket, char* out, int64_t nbytes) {
  auto* L = static_cast<Loader*>(h);
  std::unique_ptr<Blob> b;
  {
    std::lock_guard<std::mutex> g(L->mu);
    auto it = L->done.find(ticket);
    if (it == L->done.end()) return -1;
    b = std::move(it->second);
    L->done.erase(it);
  }
  if (static_cast<int64_t>(b->data.size()) != nbytes) return -2;
  std::memcpy(out, b->data.data(), static_cast<size_t>(nbytes));
  return 0;
}

// Synchronous single-file convenience wrappers.
int64_t cvo_read_npy_header(const char* path, int* ndim, int64_t* shape,
                            char* dtype) {
  std::vector<char> raw;
  Blob b;
  if (!read_file(path, raw) || !parse_npy(raw, b)) return 0;
  *ndim = b.ndim;
  for (int i = 0; i < b.ndim; ++i) shape[i] = b.shape[i];
  *dtype = b.dtype;
  return static_cast<int64_t>(b.data.size());
}

int cvo_read_npy(const char* path, char* out, int64_t nbytes) {
  std::vector<char> raw;
  Blob b;
  if (!read_file(path, raw) || !parse_npy(raw, b)) return -1;
  if (static_cast<int64_t>(b.data.size()) != nbytes) return -2;
  std::memcpy(out, b.data.data(), static_cast<size_t>(nbytes));
  return 0;
}

}  // extern "C"
