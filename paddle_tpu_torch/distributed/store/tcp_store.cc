// TCP key-value store server: the control-plane rendezvous of
// paddle_tpu_torch.distributed's launcher (reference:
// paddle/phi/core/distributed/store/tcp_store.cc — the launcher hosts the
// store, every worker connects as a client). The port keeps its own copy of
// the JAX package's server, with the same wire protocol, so the two
// packages' clients and servers interoperate.
//
// Native (C++) on purpose: the store must stay responsive while a Python
// worker holds the GIL; a thread-per-connection C++ server is immune to
// that.
//
// Wire protocol (shared with the Python client and server in __init__.py):
//   request  := cmd:u8 payload
//   SET  (1): klen:u32 key vlen:u32 val          -> ok:u8(1)
//   GET  (2): klen:u32 key                       -> found:u8 [vlen:u32 val]
//   ADD  (3): klen:u32 key delta:i64             -> newval:i64
//   WAIT (4): klen:u32 key timeout_ms:u32        -> found:u8
//   DEL  (5): klen:u32 key                       -> existed:u8
//   NUM  (6):                                    -> count:u32
//   CLR  (7): plen:u32 prefix                    -> removed:u32  (prefix "" = all)
// All integers little-endian.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Store {
  std::mutex mu;
  std::condition_variable cv;
  std::map<std::string, std::string> data;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stopping{false};
  std::thread accept_thread;
  std::vector<std::thread> conn_threads;
  std::mutex conn_mu;
  Store store;
};

bool read_exact(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool read_u32(int fd, uint32_t* v) {
  if (!read_exact(fd, v, 4)) return false;
  return true;
}

bool read_lv(int fd, std::string* out) {
  uint32_t len;
  if (!read_u32(fd, &len)) return false;
  if (len > (64u << 20)) return false;  // 64 MiB sanity cap
  out->resize(len);
  return len == 0 || read_exact(fd, &(*out)[0], len);
}

void handle_conn(Server* srv, int fd) {
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  for (;;) {
    uint8_t cmd;
    if (!read_exact(fd, &cmd, 1)) break;
    Store& st = srv->store;
    if (cmd == 1) {  // SET
      std::string key, val;
      if (!read_lv(fd, &key) || !read_lv(fd, &val)) break;
      {
        std::lock_guard<std::mutex> lk(st.mu);
        st.data[key] = std::move(val);
      }
      st.cv.notify_all();
      uint8_t ok = 1;
      if (!write_exact(fd, &ok, 1)) break;
    } else if (cmd == 2) {  // GET
      std::string key;
      if (!read_lv(fd, &key)) break;
      std::string val;
      uint8_t found = 0;
      {
        std::lock_guard<std::mutex> lk(st.mu);
        auto it = st.data.find(key);
        if (it != st.data.end()) {
          found = 1;
          val = it->second;
        }
      }
      if (!write_exact(fd, &found, 1)) break;
      if (found) {
        uint32_t len = static_cast<uint32_t>(val.size());
        if (!write_exact(fd, &len, 4)) break;
        if (len && !write_exact(fd, val.data(), len)) break;
      }
    } else if (cmd == 3) {  // ADD
      std::string key;
      int64_t delta;
      if (!read_lv(fd, &key) || !read_exact(fd, &delta, 8)) break;
      int64_t newval;
      {
        std::lock_guard<std::mutex> lk(st.mu);
        int64_t cur = 0;
        auto it = st.data.find(key);
        if (it != st.data.end() && it->second.size() == 8)
          std::memcpy(&cur, it->second.data(), 8);
        newval = cur + delta;
        std::string v(8, '\0');
        std::memcpy(&v[0], &newval, 8);
        st.data[key] = std::move(v);
      }
      st.cv.notify_all();
      if (!write_exact(fd, &newval, 8)) break;
    } else if (cmd == 4) {  // WAIT
      std::string key;
      uint32_t timeout_ms;
      if (!read_lv(fd, &key) || !read_u32(fd, &timeout_ms)) break;
      uint8_t found = 0;
      {
        std::unique_lock<std::mutex> lk(st.mu);
        auto pred = [&] { return st.data.count(key) > 0 || srv->stopping; };
        if (timeout_ms == 0) {
          st.cv.wait(lk, pred);
        } else {
          st.cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred);
        }
        found = st.data.count(key) > 0 ? 1 : 0;
      }
      if (!write_exact(fd, &found, 1)) break;
    } else if (cmd == 5) {  // DEL
      std::string key;
      if (!read_lv(fd, &key)) break;
      uint8_t existed;
      {
        std::lock_guard<std::mutex> lk(st.mu);
        existed = st.data.erase(key) ? 1 : 0;
      }
      if (!write_exact(fd, &existed, 1)) break;
    } else if (cmd == 6) {  // NUM
      uint32_t count;
      {
        std::lock_guard<std::mutex> lk(st.mu);
        count = static_cast<uint32_t>(st.data.size());
      }
      if (!write_exact(fd, &count, 4)) break;
    } else if (cmd == 7) {  // CLR
      std::string prefix;
      if (!read_lv(fd, &prefix)) break;
      uint32_t removed = 0;
      {
        std::lock_guard<std::mutex> lk(st.mu);
        for (auto it = st.data.begin(); it != st.data.end();) {
          if (it->first.compare(0, prefix.size(), prefix) == 0) {
            it = st.data.erase(it);
            ++removed;
          } else {
            ++it;
          }
        }
      }
      if (!write_exact(fd, &removed, 4)) break;
    } else {
      break;  // unknown command: drop connection
    }
  }
  ::close(fd);
}

}  // namespace

extern "C" {

// Start a store server on `port` (0 = ephemeral). Returns an opaque handle,
// or nullptr on bind failure.
void* tps_start(int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 128) != 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);

  Server* srv = new Server();
  srv->listen_fd = fd;
  srv->port = ntohs(addr.sin_port);
  srv->accept_thread = std::thread([srv] {
    for (;;) {
      int cfd = ::accept(srv->listen_fd, nullptr, nullptr);
      if (cfd < 0) {
        if (srv->stopping) return;
        continue;
      }
      std::lock_guard<std::mutex> lk(srv->conn_mu);
      srv->conn_threads.emplace_back(handle_conn, srv, cfd);
    }
  });
  return srv;
}

int tps_port(void* h) { return h ? static_cast<Server*>(h)->port : -1; }

void tps_stop(void* h) {
  if (!h) return;
  Server* srv = static_cast<Server*>(h);
  srv->stopping = true;
  srv->store.cv.notify_all();
  ::shutdown(srv->listen_fd, SHUT_RDWR);
  ::close(srv->listen_fd);
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  {
    std::lock_guard<std::mutex> lk(srv->conn_mu);
    for (auto& t : srv->conn_threads) t.detach();
  }
  // Leak srv intentionally: detached connection threads may still touch it.
  // Process teardown reclaims; tps_stop is called once at job end.
}

}  // extern "C"
