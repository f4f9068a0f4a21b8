// tpulab_client — native thin client for the tpulab_torch warm-runtime daemon.
//
// The port's copy of native/client/tpulab_client.cpp; only its cold path
// differs.  The compiled counterpart of the reference suite's per-lab
// native binaries (reference lab*/src/*.cu stdin contract): reads the
// workload payload from stdin, prints the "<DEVICE> execution time: <T ms>"
// line and payload to stdout.  Compute happens in the persistent PyTorch
// daemon (tpulab_torch/daemon.py) reached over a unix socket, so the
// harness's subprocess-per-run model (reference tester.py:126) costs a
// socket round-trip instead of CUDA init and a kernel build per run.
//
// Usage:  tpulab_client <lab> [--to-plot] [--backend B] [--key value ...]
// Socket: $TPULAB_DAEMON_SOCKET (default /tmp/tpulab.sock).  If the
// daemon is unreachable, falls back to exec'ing `python -m tpulab_torch
// run`, preserving the contract (cold, but correct).
//
// Wire protocol: see tpulab_torch/daemon.py docstring.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <csignal>

#include <sys/socket.h>
#include <sys/un.h>
#include <sys/wait.h>
#include <unistd.h>

namespace {

std::string read_all_stdin() {
  std::string buf;
  char chunk[1 << 16];
  size_t n;
  while ((n = fread(chunk, 1, sizeof(chunk), stdin)) > 0) buf.append(chunk, n);
  return buf;
}

// Minimal JSON string escaping (keys/values are shell words; no control
// characters expected, but escape to stay valid).
std::string json_escape(const std::string& s) {
  std::string out;
  out.reserve(s.size() + 8);
  for (char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\n': out += "\\n"; break;
      case '\t': out += "\\t"; break;
      case '\r': out += "\\r"; break;
      default: out += c;
    }
  }
  return out;
}

// Strict JSON number grammar (RFC 8259): -?(0|[1-9][0-9]*)(\.[0-9]+)?
// ([eE][+-]?[0-9]+)?.  Looser sniffing ("007", "1.", "-", ".") would
// emit invalid JSON the daemon's json.loads rejects; anything failing
// this grammar is forwarded as a quoted string instead.
bool is_json_number(const std::string& v) {
  size_t i = 0, n = v.size();
  auto digit = [&](size_t j) { return j < n && v[j] >= '0' && v[j] <= '9'; };
  if (i < n && v[i] == '-') ++i;
  if (!digit(i)) return false;
  if (v[i] == '0') ++i;
  else while (digit(i)) ++i;
  if (i < n && v[i] == '.') {
    ++i;
    if (!digit(i)) return false;
    while (digit(i)) ++i;
  }
  if (i < n && (v[i] == 'e' || v[i] == 'E')) {
    ++i;
    if (i < n && (v[i] == '+' || v[i] == '-')) ++i;
    if (!digit(i)) return false;
    while (digit(i)) ++i;
  }
  return i == n;
}

// --key value pairs -> JSON object with bool/number passthrough (the
// daemon's workload kwargs are type-coerced Python-side as well; numbers
// are forwarded unquoted so e.g. --reps 5 arrives as an int).
std::string config_json(const std::vector<std::pair<std::string, std::string>>& kv) {
  std::string out = "{";
  bool first = true;
  for (const auto& [k, v] : kv) {
    if (!first) out += ",";
    first = false;
    out += "\"" + json_escape(k) + "\":";
    if (v == "true" || v == "false" || is_json_number(v))
      out += v;
    else
      out += "\"" + json_escape(v) + "\"";
  }
  return out + "}";
}

bool send_exact(int fd, const void* data, size_t n) {
  const char* p = static_cast<const char*>(data);
  while (n) {
    ssize_t w = write(fd, p, n);
    if (w <= 0) return false;
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool recv_exact(int fd, void* data, size_t n) {
  char* p = static_cast<char*>(data);
  while (n) {
    ssize_t r = read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

[[noreturn]] void exec_python_cli(int argc, char** argv) {
  // cold path: python -m tpulab_torch run <lab> [--to-plot] [--backend B] [extras]
  std::vector<char*> args;
  static char py[] = "python3";
  static char dash_m[] = "-m";
  static char mod[] = "tpulab_torch";
  static char run[] = "run";
  args = {py, dash_m, mod, run};
  for (int i = 1; i < argc; ++i) args.push_back(argv[i]);
  args.push_back(nullptr);
  execvp("python3", args.data());
  // try plain `python` if python3 is absent
  static char py2[] = "python";
  args[0] = py2;
  execvp("python", args.data());
  perror("tpulab_client: exec python fallback failed");
  exit(127);
}

[[noreturn]] void fallback_with_payload(int argc, char** argv,
                                        const std::string& payload) {
  // stdin is already consumed into `payload` (read before connecting so
  // the daemon's handler slot isn't held during stdin ingestion), so a
  // plain re-exec would hand the CLI an empty stdin — feed the captured
  // payload through a pipe instead.
  int fds[2];
  if (pipe(fds) != 0) {
    perror("tpulab_client: pipe for fallback failed");
    exit(127);
  }
  pid_t pid = fork();
  if (pid < 0) {
    perror("tpulab_client: fork for fallback failed");
    exit(127);
  }
  if (pid == 0) {
    close(fds[1]);
    if (dup2(fds[0], 0) < 0) _exit(127);
    close(fds[0]);
    exec_python_cli(argc, argv);
  }
  close(fds[0]);
  // child may exit before draining (e.g. bad args): a SIGPIPE here must
  // not kill us before we can report its exit status
  signal(SIGPIPE, SIG_IGN);
  size_t off = 0;
  while (off < payload.size()) {
    ssize_t w = write(fds[1], payload.data() + off, payload.size() - off);
    if (w < 0) {
      if (errno == EINTR) continue;
      break;  // child gone; its status is the answer
    }
    off += static_cast<size_t>(w);
  }
  close(fds[1]);
  int st = 0;
  waitpid(pid, &st, 0);
  exit(WIFEXITED(st) ? WEXITSTATUS(st) : 128 + WTERMSIG(st));
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s <lab> [--to-plot] [--backend B] [--key value ...]\n", argv[0]);
    return 2;
  }
  std::string lab = argv[1];
  bool sweep = false;
  std::string backend;
  std::vector<std::pair<std::string, std::string>> cfg;
  for (int i = 2; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--to-plot" || a == "--to_plot") {
      sweep = true;
    } else if (a == "--backend" && i + 1 < argc) {
      backend = argv[++i];
    } else if (a.rfind("--", 0) == 0 && i + 1 < argc) {
      cfg.emplace_back(a.substr(2), argv[++i]);
    } else {
      fprintf(stderr, "tpulab_client: unrecognized arg %s\n", a.c_str());
      return 2;
    }
  }

  const char* sock_env = getenv("TPULAB_DAEMON_SOCKET");
  std::string sock_path = sock_env && *sock_env ? sock_env : "/tmp/tpulab.sock";
  if (sock_path.size() >= sizeof(sockaddr_un{}.sun_path)) {
    exec_python_cli(argc, argv);  // unusable socket path: cold path
  }
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  strncpy(addr.sun_path, sock_path.c_str(), sizeof(addr.sun_path) - 1);

  // Cheap daemon-presence check WITHOUT connecting: the common
  // no-daemon cold path must keep handing python an untouched streaming
  // stdin (no double-buffering of multi-hundred-MB payloads), and a
  // throwaway probe connection would both churn a daemon handler slot
  // and double-count against --max-requests.  A stale socket file
  // (daemon crashed) is rare and still correct: we buffer stdin, the
  // real connect below fails, and fallback_with_payload pipes the
  // captured bytes to the python CLI.
  if (access(sock_path.c_str(), F_OK) != 0) {
    exec_python_cli(argc, argv);
  }

  // Socket file exists: slurp stdin BEFORE the real connect — from
  // connect() on, the daemon holds a bounded handler slot with an
  // eviction deadline (tpulab_torch/daemon.py RECV_TIMEOUT_S), and time spent
  // by a slow upstream producer must not count against it.
  std::string payload = read_all_stdin();

  int fd = socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) {
    fallback_with_payload(argc, argv, payload);
  }
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) == 0) {
    std::string header = "{\"lab\":\"" + json_escape(lab) + "\"";
    header += ",\"sweep\":" + std::string(sweep ? "true" : "false");
    header += ",\"backend\":" +
              (backend.empty() ? std::string("null")
                               : "\"" + json_escape(backend) + "\"");
    header += ",\"config\":" + config_json(cfg) + "}";

    uint32_t hlen = static_cast<uint32_t>(header.size());
    uint64_t plen = payload.size();
    bool ok = send_exact(fd, &hlen, 4) && send_exact(fd, header.data(), hlen) &&
              send_exact(fd, &plen, 8) && send_exact(fd, payload.data(), plen);
    // Frame loop: status-2 CHUNK frames (streaming generate) print as
    // they arrive; the terminal frame (0 ok / 1 error) ends the
    // request.  After streamed chunks the terminal body is suppressed
    // on stdout — it repeats the full output for non-streaming readers.
    bool streamed = false;
    while (ok) {
      uint8_t status = 255;
      uint64_t rlen = 0;
      if (!recv_exact(fd, &status, 1) || !recv_exact(fd, &rlen, 8)) break;
      std::string out(rlen, '\0');
      if (!recv_exact(fd, out.data(), rlen)) break;
      if (status == 2) {
        fwrite(out.data(), 1, out.size(), stdout);
        fflush(stdout);
        streamed = true;
        continue;
      }
      close(fd);
      if (status == 0) {
        if (!streamed) fwrite(out.data(), 1, out.size(), stdout);
        return 0;
      }
      fwrite(out.data(), 1, out.size(), stderr);
      return 1;
    }
    if (streamed) {
      // partial output already reached stdout: a fallback rerun would
      // duplicate it — report the broken stream instead
      fprintf(stderr, "tpulab_client: stream broken mid-response\n");
      close(fd);
      return 1;
    }
    fprintf(stderr, "tpulab_client: daemon protocol error, falling back\n");
    close(fd);
    fallback_with_payload(argc, argv, payload);
  }
  close(fd);
  // stale socket file or refused connect: the daemon is gone — pipe the
  // already-captured payload through the python CLI
  fallback_with_payload(argc, argv, payload);
}
