// KV-transfer side-channel server: the native data plane for P/D disaggregation.
//
// Plays the role the reference fills with NIXL v1.2.0 (C++,
// docker/Dockerfile.cuda:51-53; pull-model one-sided reads,
// docs/infrastructure/rdma/README.md:17-60) on the TPU host-staged path: the
// prefill host registers contiguous KV staging buffers; decode hosts pull them
// over TCP with a tiny framed protocol. Serving stays off the Python GIL so
// concurrent decode pulls stream at NIC speed while the engine keeps stepping.
//
// Wire protocol (shared with llmd_tpu/disagg/transfer.py — either side may be
// the Python implementation):
//   request:  "KVT1" | u32be len | JSON {"op": "pull"|"notify", "id": str}
//   response: u32be len | JSON header | payload[header.nbytes]
//
// C API (ctypes-consumed, no pybind11 in the image):
//   kvt_server_create(port)->handle   kvt_server_port(h)
//   kvt_register(h,id,hdr,hdr_len,payload,payload_len)   kvt_release(h,id)
//   kvt_count(h)   kvt_reap(h,ttl_s)->freed   kvt_stat(h,name)->counter
//   kvt_server_destroy(h)

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr char kMagic[4] = {'K', 'V', 'T', '1'};

struct Export {
  std::string header;            // JSON, includes "nbytes"
  std::vector<uint8_t> payload;  // contiguous block bytes
  std::chrono::steady_clock::time_point created;
};

struct Server {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stop{false};
  std::thread accept_thread;
  std::mutex mu;
  std::map<std::string, std::shared_ptr<Export>> exports;
  std::atomic<long> pulls{0}, misses{0}, notifies{0}, expired{0}, registered{0};
  std::atomic<int> active_conns{0};
};

bool recv_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_all(int fd, const void* buf, size_t n) {
  auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_frame(int fd, const std::string& header) {
  uint32_t len = htonl(static_cast<uint32_t>(header.size()));
  return send_all(fd, &len, 4) && send_all(fd, header.data(), header.size());
}

// Minimal field scan — requests are {"op": "...", "id": "..."} produced by our own
// clients; ids never contain quotes/escapes (uuid hex + "cmpl-" prefixes).
std::string json_str_field(const std::string& s, const std::string& key) {
  std::string pat = "\"" + key + "\"";
  size_t k = s.find(pat);
  if (k == std::string::npos) return "";
  size_t q1 = s.find('"', k + pat.size() + 1);  // skip ':'
  if (q1 == std::string::npos) return "";
  size_t q2 = s.find('"', q1 + 1);
  if (q2 == std::string::npos) return "";
  return s.substr(q1 + 1, q2 - q1 - 1);
}

void serve_conn(Server* srv, int fd) {
  struct ConnGuard {
    Server* s;
    ~ConnGuard() { s->active_conns--; }
  } guard{srv};
  struct timeval tv{30, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  // A connection may carry several requests (handshake reuse, ~5s-once-per-pair
  // semantics of the reference's lazy NIXL handshake).
  while (!srv->stop.load()) {
    char magic[4];
    if (!recv_exact(fd, magic, 4) || memcmp(magic, kMagic, 4) != 0) break;
    uint32_t len_be;
    if (!recv_exact(fd, &len_be, 4)) break;
    uint32_t len = ntohl(len_be);
    if (len > (1u << 20)) break;
    std::string req(len, '\0');
    if (!recv_exact(fd, req.data(), len)) break;
    std::string op = json_str_field(req, "op");
    std::string id = json_str_field(req, "id");

    if (op == "pull") {
      std::shared_ptr<Export> ex;
      {
        std::lock_guard<std::mutex> lock(srv->mu);
        auto it = srv->exports.find(id);
        if (it != srv->exports.end()) ex = it->second;
      }
      if (!ex) {
        srv->misses++;
        if (!send_frame(fd, "{\"found\": false, \"nbytes\": 0}")) break;
        continue;
      }
      srv->pulls++;
      if (!send_frame(fd, ex->header)) break;
      if (!send_all(fd, ex->payload.data(), ex->payload.size())) break;
    } else if (op == "notify") {
      {
        std::lock_guard<std::mutex> lock(srv->mu);
        srv->exports.erase(id);
      }
      srv->notifies++;
      if (!send_frame(fd, "{\"ok\": true, \"nbytes\": 0}")) break;
    } else {
      break;
    }
  }
  close(fd);
}

void accept_loop(Server* srv) {
  while (!srv->stop.load()) {
    sockaddr_in addr{};
    socklen_t alen = sizeof(addr);
    int fd = accept(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
    if (fd < 0) {
      if (srv->stop.load()) return;
      continue;
    }
    srv->active_conns++;
    std::thread(serve_conn, srv, fd).detach();
  }
}

}  // namespace

extern "C" {

void* kvt_server_create(int port) {
  auto* srv = new Server();
  srv->listen_fd = socket(AF_INET, SOCK_STREAM, 0);
  if (srv->listen_fd < 0) {
    delete srv;
    return nullptr;
  }
  int one = 1;
  setsockopt(srv->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      listen(srv->listen_fd, 128) < 0) {
    close(srv->listen_fd);
    delete srv;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(srv->listen_fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  srv->port = ntohs(addr.sin_port);
  srv->accept_thread = std::thread(accept_loop, srv);
  return srv;
}

int kvt_server_port(void* h) { return static_cast<Server*>(h)->port; }

void kvt_register(void* h, const char* id, const char* header, int header_len,
                  const uint8_t* payload, long payload_len) {
  auto* srv = static_cast<Server*>(h);
  auto ex = std::make_shared<Export>();
  ex->header.assign(header, static_cast<size_t>(header_len));
  ex->payload.assign(payload, payload + payload_len);
  ex->created = std::chrono::steady_clock::now();
  std::lock_guard<std::mutex> lock(srv->mu);
  srv->exports[id] = std::move(ex);
  srv->registered++;
}

void kvt_release(void* h, const char* id) {
  auto* srv = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lock(srv->mu);
  srv->exports.erase(id);
}

int kvt_count(void* h) {
  auto* srv = static_cast<Server*>(h);
  std::lock_guard<std::mutex> lock(srv->mu);
  return static_cast<int>(srv->exports.size());
}

int kvt_reap(void* h, double ttl_s) {
  auto* srv = static_cast<Server*>(h);
  auto cutoff = std::chrono::steady_clock::now() -
                std::chrono::duration_cast<std::chrono::steady_clock::duration>(
                    std::chrono::duration<double>(ttl_s));
  int freed = 0;
  std::lock_guard<std::mutex> lock(srv->mu);
  for (auto it = srv->exports.begin(); it != srv->exports.end();) {
    if (it->second->created < cutoff) {
      it = srv->exports.erase(it);
      freed++;
    } else {
      ++it;
    }
  }
  srv->expired += freed;
  return freed;
}

long kvt_stat(void* h, const char* name) {
  auto* srv = static_cast<Server*>(h);
  std::string n(name);
  if (n == "pulls") return srv->pulls.load();
  if (n == "misses") return srv->misses.load();
  if (n == "notifies") return srv->notifies.load();
  if (n == "expired") return srv->expired.load();
  if (n == "exports") return srv->registered.load();
  return -1;
}

void kvt_server_destroy(void* h) {
  auto* srv = static_cast<Server*>(h);
  srv->stop.store(true);
  shutdown(srv->listen_fd, SHUT_RDWR);
  close(srv->listen_fd);
  if (srv->accept_thread.joinable()) srv->accept_thread.join();
  // Detached connection threads still reference srv; wait (bounded) for them to
  // drain. If one is stuck in a 30s recv timeout we leak srv instead of risking
  // use-after-free — destroy runs at process teardown, where a leak is benign.
  for (int i = 0; i < 2000 && srv->active_conns.load() > 0; i++) {
    std::this_thread::sleep_for(std::chrono::milliseconds(1));
  }
  if (srv->active_conns.load() == 0) delete srv;
}

}  // extern "C"
