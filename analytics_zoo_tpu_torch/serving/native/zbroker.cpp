// zbroker — native stream broker for Cluster Serving.
//
// The PyTorch port's own copy of analytics_zoo_tpu/serving/native/
// zbroker.cpp: the same protocol, byte for byte, so either package's
// clients and engines talk to either package's broker. It stands in for
// the Redis server the reference uses as its serving data plane (ref
// zoo/.../serving/engine/FlinkRedisSource.scala:32-106 consumes via
// XREADGROUP, FlinkRedisSink XADDs results): a single-file C++ broker
// speaking a line protocol with the subset of semantics serving needs:
//
//   PING                                        -> +PONG
//   XADD <stream> <b64> [lane]                  -> +<id> | -SHED ... when
//                                                  the lane's shed flag is
//                                                  set (lane defaults to
//                                                  "default")
//   XLEN <stream> [lane]                        -> :<n> (lane-filtered
//                                                  when lane given)
//   XREADGROUP <group> <consumer> <stream> <count> <block_ms> [lanes]
//                                               -> *<n> then n lines
//                                                  "<id> <b64>", or
//                                                  "<id> <lane> <b64>"
//                                                  when lanes (comma-
//                                                  separated priority
//                                                  order) is given —
//                                                  delivery drains lanes
//                                                  in that order
//   XACK <stream> <group> <id>                  -> :<n-acked>
//   XCLAIM <stream> <group> <consumer> <min_idle_ms> <count> [lanes]
//                                               -> *<n> then n lines
//                                                  "<id> <b64>" (laneless)
//                                                  or "<id> <lane> <b64>",
//                                                  claiming in lane order
//   XPENDING <stream> <group>                   -> :<n-pending>
//   XPENDING <stream> <group> DETAIL            -> *<n> then n lines
//                                                  "<consumer> <count>"
//   XSHED <stream> <lane> <0|1>                 -> +OK (set/clear the
//                                                  lane's admission shed
//                                                  flag)
//   XSHED <stream>                              -> *<n> then n lines
//                                                  "<lane>" (shedding)
//   HSET <key> <field> <b64>                    -> +OK
//   HGET <key> <field>                          -> $<b64> | $-1
//   HKEYS <key>                                 -> *<n> then n lines "<field>"
//   HDEL <key> <field>                          -> :<n-deleted>
//   DEL <key>                                   -> +OK
//   SHUTDOWN                                    -> +BYE (process exits)
//
// Concurrency: one thread per connection; one global mutex over state (the
// payloads are opaque b64 strings, so critical sections are pointer work);
// blocking XREADGROUP waits on a condition_variable. Delivery semantics
// mirror Redis streams: per-(stream,group,lane) cursor of last-delivered
// id (one id space across lanes, so ack/lease/GC semantics stay unified
// while delivery partitions by priority); un-ACKed entries are tracked per
// group with their owning consumer and last-delivery time — a delivery
// LEASE: XCLAIM transfers entries whose lease has been idle past
// min_idle_ms to another consumer (never back to their current owner),
// and XPENDING DETAIL attributes the backlog per consumer for crash
// visibility.
//
// Build: c++ -O2 -std=c++17 -pthread -o zbroker zbroker.cpp
// (serving/broker.py builds it at first use into build/native/).

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <sstream>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Entry {
  long long id;
  std::string payload;
  std::string lane;  // priority class; "default" when XADD gave none
};

struct PendingEntry {
  std::string consumer;  // current lease owner
  long long ts = 0;      // last delivery (ms, steady clock) — the lease
  long long deliveries = 0;  // total deliveries incl. XCLAIM redeliveries
  std::string lane;          // so XCLAIM can recover by priority
};

struct Group {
  // last delivered id PER LANE: draining one lane must not mark another
  // lane's (lower-id) entries as already seen
  std::map<std::string, long long> cursor;
  // delivered-not-acked: id -> lease record, so XCLAIM can re-deliver
  // entries whose owning consumer died (lease idle too long) and
  // XPENDING DETAIL can attribute backlog per consumer
  std::map<long long, PendingEntry> pending;
};

long long NowMs() {
  // steady clock: TTL/idle arithmetic must not jump with NTP steps or
  // suspend/resume (all uses are relative durations)
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct Stream {
  std::vector<Entry> entries;
  long long next_id = 1;
  std::map<std::string, Group> groups;
};

std::mutex g_mu;
std::condition_variable g_cv;
std::map<std::string, Stream> g_streams;
// stream -> lanes whose XADDs are rejected (admission control, see XSHED)
std::map<std::string, std::set<std::string>> g_shed;
std::map<std::string, std::map<std::string, std::string>> g_hashes;
// last-write time per hash field: the result hash would otherwise grow
// forever if a client never collects (TTL eviction bounds broker memory;
// Redis gets this from EXPIRE, ref serving keeps results in a Redis hash)
std::map<std::string, std::map<std::string, long long>> g_hash_times;
// write-order FIFO per key: g_hash_times is name-ordered, so bounding the
// HSET-path eviction to the OLDEST fields needs a separate queue. Entries
// for fields already evicted (or since rewritten) are skipped on pop via
// a timestamp match against g_hash_times.
std::map<std::string,
         std::deque<std::pair<std::string, long long>>> g_hash_fifo;
long long g_hash_ttl_ms = 600000;  // 0 disables
bool g_shutdown = false;
int g_srv_fd = -1;

// drop expired fields of one hash key; caller holds g_mu
void EvictExpired(const std::string& key, long long now_ms) {
  if (g_hash_ttl_ms <= 0) return;
  auto t = g_hash_times.find(key);
  if (t == g_hash_times.end()) return;
  auto h = g_hashes.find(key);
  for (auto it = t->second.begin(); it != t->second.end();) {
    if (now_ms - it->second >= g_hash_ttl_ms) {
      if (h != g_hashes.end()) h->second.erase(it->first);
      it = t->second.erase(it);
    } else {
      ++it;
    }
  }
  if (t->second.empty()) {
    g_hash_times.erase(t);
    g_hash_fifo.erase(key);  // all fields gone -> queue is all stale
  }
  if (h != g_hashes.end() && h->second.empty()) g_hashes.erase(h);
}

// Amortized eviction for the HSET hot path: pop at most `limit` expired
// entries off the key's write-order FIFO. A full-key scan here is
// O(live fields) per write exactly when the result consumer is slow —
// the scenario TTL exists for; the ttl/4 sweeper bounds memory anyway.
// Caller holds g_mu.
void EvictSome(const std::string& key, long long now_ms, int limit) {
  if (g_hash_ttl_ms <= 0) return;
  auto q = g_hash_fifo.find(key);
  if (q == g_hash_fifo.end()) return;
  auto t = g_hash_times.find(key);
  auto h = g_hashes.find(key);
  int n = 0;
  while (!q->second.empty() && n < limit) {
    auto& front = q->second.front();
    bool current = false;
    if (t != g_hash_times.end()) {
      auto ft = t->second.find(front.first);
      // the queue entry is the field's CURRENT write only if the
      // timestamps match — otherwise it's a tombstone (field HDEL'd by
      // the consumer, or rewritten with a later queue entry covering it)
      current = ft != t->second.end() && ft->second == front.second;
    }
    if (!current) {
      // tombstones pop regardless of age: under a healthy
      // write-then-HDEL serving flow nearly every entry becomes one,
      // and keeping them for the full TTL would hold O(rate x TTL)
      // memory that the pre-FIFO implementation never did
      q->second.pop_front();
      ++n;
      continue;
    }
    if (now_ms - front.second < g_hash_ttl_ms) break;  // oldest is live
    t->second.erase(front.first);
    if (h != g_hashes.end()) h->second.erase(front.first);
    q->second.pop_front();
    ++n;
  }
  if (q->second.empty()) g_hash_fifo.erase(q);
  if (t != g_hash_times.end() && t->second.empty()) g_hash_times.erase(t);
  if (h != g_hashes.end() && h->second.empty()) g_hashes.erase(h);
}

// periodic sweep so memory stays bounded even with no client traffic
void SweeperLoop() {
  std::unique_lock<std::mutex> lk(g_mu);
  while (!g_shutdown) {
    long long wait_ms = g_hash_ttl_ms > 0 ? std::max(g_hash_ttl_ms / 4,
                                                     1000LL)
                                          : 60000LL;
    g_cv.wait_for(lk, std::chrono::milliseconds(wait_ms),
                  []() { return g_shutdown; });
    if (g_shutdown) break;
    long long now_ms = NowMs();
    std::vector<std::string> keys;
    for (auto& kv : g_hash_times) keys.push_back(kv.first);
    for (auto& k : keys) EvictExpired(k, now_ms);
  }
}

// Per-connection receive buffer: bulk recv instead of byte-at-a-time
// syscalls, and leftover bytes carry over so pipelined commands (many
// lines in one TCP segment) parse correctly.
struct ConnBuf {
  std::string buf;
  size_t pos = 0;
};

std::string ReadLine(int fd, ConnBuf* cb, bool* ok) {
  while (true) {
    size_t nl = cb->buf.find('\n', cb->pos);
    if (nl != std::string::npos) {
      std::string line = cb->buf.substr(cb->pos, nl - cb->pos);
      cb->pos = nl + 1;
      if (cb->pos > (1u << 20)) {  // compact consumed prefix
        cb->buf.erase(0, cb->pos);
        cb->pos = 0;
      }
      if (!line.empty() && line.back() == '\r') line.pop_back();
      *ok = true;
      return line;
    }
    if (cb->buf.size() - cb->pos > (64u << 20)) {
      *ok = false;
      return std::string();
    }
    char chunk[65536];
    ssize_t n = recv(fd, chunk, sizeof(chunk), 0);
    if (n <= 0) {
      *ok = false;
      return std::string();
    }
    cb->buf.append(chunk, static_cast<size_t>(n));
  }
}

void SendAll(int fd, const std::string& s) {
  size_t off = 0;
  while (off < s.size()) {
    ssize_t n = send(fd, s.data() + off, s.size() - off, MSG_NOSIGNAL);
    if (n <= 0) return;
    off += static_cast<size_t>(n);
  }
}

std::vector<std::string> Split(const std::string& s, size_t max_parts) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i < s.size() && out.size() + 1 < max_parts) {
    size_t j = s.find(' ', i);
    if (j == std::string::npos) break;
    out.push_back(s.substr(i, j - i));
    i = j + 1;
  }
  if (i <= s.size()) out.push_back(s.substr(i));
  return out;
}

// "a,b,c" -> {"a","b","c"} (the lanes argument of XREADGROUP/XCLAIM)
std::vector<std::string> SplitComma(const std::string& s) {
  std::vector<std::string> out;
  size_t i = 0;
  while (i <= s.size()) {
    size_t j = s.find(',', i);
    if (j == std::string::npos) j = s.size();
    if (j > i) out.push_back(s.substr(i, j - i));
    i = j + 1;
  }
  return out;
}

void HandleConn(int fd) {
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  ConnBuf cb;
  while (true) {
    bool ok;
    std::string line = ReadLine(fd, &cb, &ok);
    if (!ok) break;
    if (line.empty()) continue;
    std::vector<std::string> p = Split(line, 8);
    const std::string& cmd = p[0];

    if (cmd == "PING") {
      SendAll(fd, "+PONG\n");
    } else if (cmd == "SHUTDOWN") {
      SendAll(fd, "+BYE\n");
      {
        std::lock_guard<std::mutex> lk(g_mu);
        g_shutdown = true;
      }
      g_cv.notify_all();
      if (g_srv_fd >= 0) shutdown(g_srv_fd, SHUT_RDWR);  // unblock accept()
      break;
    } else if (cmd == "XADD" && p.size() >= 3) {
      const std::string lane = p.size() >= 4 ? p[3] : "default";
      long long id = 0;
      bool shed = false;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        auto sh = g_shed.find(p[1]);
        if (sh != g_shed.end() && sh->second.count(lane)) {
          shed = true;
        } else {
          Stream& st = g_streams[p[1]];
          id = st.next_id++;
          st.entries.push_back({id, p[2], lane});
        }
      }
      if (shed) {
        SendAll(fd, "-SHED lane " + lane + " is shedding\n");
      } else {
        g_cv.notify_all();
        SendAll(fd, "+" + std::to_string(id) + "\n");
      }
    } else if (cmd == "XLEN" && p.size() >= 2) {
      std::lock_guard<std::mutex> lk(g_mu);
      size_t n = 0;
      if (p.size() >= 3 && !p[2].empty()) {
        for (const Entry& e : g_streams[p[1]].entries)
          if (e.lane == p[2]) ++n;
      } else {
        n = g_streams[p[1]].entries.size();
      }
      SendAll(fd, ":" + std::to_string(n) + "\n");
    } else if (cmd == "XREADGROUP" && p.size() >= 6) {
      const std::string &group = p[1], &consumer = p[2], &stream = p[3];
      int count = atoi(p[4].c_str());
      int block_ms = atoi(p[5].c_str());
      // optional lanes arg: comma-separated delivery order — lanes[0]
      // drains first. Empty/missing = legacy laneless delivery in id
      // order, replies without the lane field.
      const bool laned = p.size() >= 7 && !p[6].empty();
      std::vector<std::string> lanes =
          laned ? SplitComma(p[6]) : std::vector<std::string>{""};
      std::vector<Entry> got;
      {
        std::unique_lock<std::mutex> lk(g_mu);
        auto deliver = [&]() {
          Stream& st = g_streams[stream];
          Group& gr = st.groups[group];
          long long now_ms = NowMs();
          for (const std::string& want : lanes) {
            for (const Entry& e : st.entries) {
              if (laned && e.lane != want) continue;
              auto c = gr.cursor.find(e.lane);
              if (c != gr.cursor.end() && e.id <= c->second) continue;
              got.push_back(e);
              gr.cursor[e.lane] = e.id;
              gr.pending[e.id] = PendingEntry{consumer, now_ms, 1, e.lane};
              if (static_cast<int>(got.size()) >= count) return true;
            }
          }
          return !got.empty();
        };
        if (!deliver() && block_ms > 0) {
          g_cv.wait_for(lk, std::chrono::milliseconds(block_ms), [&]() {
            return g_shutdown || deliver();
          });
        }
      }
      std::ostringstream os;
      os << "*" << got.size() << "\n";
      for (const Entry& e : got) {
        if (laned) os << e.id << " " << e.lane << " " << e.payload << "\n";
        else os << e.id << " " << e.payload << "\n";
      }
      SendAll(fd, os.str());
    } else if (cmd == "XACK" && p.size() >= 4) {
      int n = 0;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        Stream& st = g_streams[p[1]];
        Group& gr = st.groups[p[2]];
        n = static_cast<int>(gr.pending.erase(atoll(p[3].c_str())));
        // GC: drop entries delivered to every group and acked everywhere
        // (Redis needs explicit XTRIM; serving never re-reads old ids).
        // Cursors are per-lane: an entry is collectible only when every
        // group has passed it ON ITS LANE and nobody holds it pending;
        // the prefix drop stops at the first keeper.
        if (!st.groups.empty()) {
          size_t drop = 0;
          while (drop < st.entries.size()) {
            const Entry& e = st.entries[drop];
            bool consumed = true;
            for (auto& kv : st.groups) {
              auto c = kv.second.cursor.find(e.lane);
              long long cur = c == kv.second.cursor.end() ? 0 : c->second;
              if (cur < e.id || kv.second.pending.count(e.id)) {
                consumed = false;
                break;
              }
            }
            if (!consumed) break;
            ++drop;
          }
          if (drop > 0)
            st.entries.erase(st.entries.begin(), st.entries.begin() + drop);
        }
      }
      SendAll(fd, ":" + std::to_string(n) + "\n");
    } else if (cmd == "XCLAIM" && p.size() >= 6) {
      // XCLAIM <stream> <group> <consumer> <min_idle_ms> <count> [lanes]:
      // re-deliver pending entries whose lease expired — idle >=
      // min_idle_ms AND owned by a DIFFERENT consumer (recovery of
      // entries whose consumer died before XACK — Redis XAUTOCLAIM
      // analog). Claiming transfers ownership, refreshes the lease
      // clock and bumps the delivery count. With lanes the claim drains
      // lanes in the given order (a dead replica's interactive leases
      // come back before its batch backlog) and replies carry the lane.
      const std::string& claimer = p[3];
      long long min_idle = atoll(p[4].c_str());
      int count = atoi(p[5].c_str());
      const bool laned = p.size() >= 7 && !p[6].empty();
      std::vector<std::string> lanes =
          laned ? SplitComma(p[6]) : std::vector<std::string>{""};
      std::vector<Entry> got;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        Stream& st = g_streams[p[1]];
        Group& gr = st.groups[p[2]];
        long long now_ms = NowMs();
        if (!gr.pending.empty()) {
          // one id->payload index per call, not an O(entries) scan per
          // pending id (the engine polls XCLAIM; backlog must stay cheap)
          std::map<long long, const Entry*> index;
          for (const Entry& e : st.entries) index[e.id] = &e;
          for (const std::string& want : lanes) {
            if (static_cast<int>(got.size()) >= count) break;
            for (auto& kv : gr.pending) {
              if (static_cast<int>(got.size()) >= count) break;
              if (kv.second.consumer == claimer) continue;
              if (laned && kv.second.lane != want) continue;
              if (now_ms - kv.second.ts < min_idle) continue;
              auto it = index.find(kv.first);
              if (it != index.end()) {
                got.push_back(*it->second);
                kv.second.consumer = claimer;
                kv.second.ts = now_ms;
                kv.second.deliveries += 1;
              }
            }
          }
        }
      }
      std::ostringstream os;
      os << "*" << got.size() << "\n";
      for (const Entry& e : got) {
        if (laned) os << e.id << " " << e.lane << " " << e.payload << "\n";
        else os << e.id << " " << e.payload << "\n";
      }
      SendAll(fd, os.str());
    } else if (cmd == "XSHED" && p.size() >= 4) {
      // XSHED <stream> <lane> <0|1>: set/clear the lane's admission shed
      // flag (absolute write — the engine repeats it safely)
      {
        std::lock_guard<std::mutex> lk(g_mu);
        if (p[3] == "0") g_shed[p[1]].erase(p[2]);
        else g_shed[p[1]].insert(p[2]);
      }
      SendAll(fd, "+OK\n");
    } else if (cmd == "XSHED" && p.size() >= 2) {
      std::ostringstream os;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        auto sh = g_shed.find(p[1]);
        size_t n = sh == g_shed.end() ? 0 : sh->second.size();
        os << "*" << n << "\n";
        if (sh != g_shed.end())
          for (const std::string& lane : sh->second) os << lane << "\n";
      }
      SendAll(fd, os.str());
    } else if (cmd == "XPENDING" && p.size() >= 4) {
      // XPENDING <stream> <group> DETAIL -> per-consumer pending counts
      // ("<consumer> <count>" lines, sorted by consumer id)
      std::map<std::string, long long> per;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        Group& gr = g_streams[p[1]].groups[p[2]];
        for (auto& kv : gr.pending) per[kv.second.consumer] += 1;
      }
      std::ostringstream os;
      os << "*" << per.size() << "\n";
      for (auto& kv : per) os << kv.first << " " << kv.second << "\n";
      SendAll(fd, os.str());
    } else if (cmd == "XPENDING" && p.size() >= 3) {
      std::lock_guard<std::mutex> lk(g_mu);
      Group& gr = g_streams[p[1]].groups[p[2]];
      SendAll(fd, ":" + std::to_string(gr.pending.size()) + "\n");
    } else if (cmd == "HSET" && p.size() >= 4) {
      {
        std::lock_guard<std::mutex> lk(g_mu);
        long long now_ms = NowMs();
        EvictSome(p[1], now_ms, 8);  // bounded: full scan is O(live
                                     // fields) under a slow consumer
        g_hashes[p[1]][p[2]] = p[3];
        if (g_hash_ttl_ms > 0) {
          g_hash_times[p[1]][p[2]] = now_ms;
          g_hash_fifo[p[1]].emplace_back(p[2], now_ms);
        }
      }
      g_cv.notify_all();
      SendAll(fd, "+OK\n");
    } else if (cmd == "HGET" && p.size() >= 3) {
      std::string val;
      bool found = false;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        auto h = g_hashes.find(p[1]);
        if (h != g_hashes.end()) {
          auto f = h->second.find(p[2]);
          if (f != h->second.end()) { val = f->second; found = true; }
        }
        if (found && g_hash_ttl_ms > 0) {
          // only the requested field's clock — O(log n), not a key scan
          auto t = g_hash_times.find(p[1]);
          if (t != g_hash_times.end()) {
            auto ft = t->second.find(p[2]);
            if (ft != t->second.end() &&
                NowMs() - ft->second >= g_hash_ttl_ms) {
              h->second.erase(p[2]);
              t->second.erase(ft);
              found = false;
            }
          }
        }
      }
      SendAll(fd, found ? "$" + val + "\n" : "$-1\n");
    } else if (cmd == "HKEYS" && p.size() >= 2) {
      std::ostringstream os;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        EvictExpired(p[1], NowMs());
        auto h = g_hashes.find(p[1]);
        size_t n = (h == g_hashes.end()) ? 0 : h->second.size();
        os << "*" << n << "\n";
        if (h != g_hashes.end())
          for (auto& kv : h->second) os << kv.first << "\n";
      }
      SendAll(fd, os.str());
    } else if (cmd == "HDEL" && p.size() >= 3) {
      int n = 0;
      {
        std::lock_guard<std::mutex> lk(g_mu);
        auto h = g_hashes.find(p[1]);
        if (h != g_hashes.end())
          n = static_cast<int>(h->second.erase(p[2]));
        auto t = g_hash_times.find(p[1]);
        if (t != g_hash_times.end()) t->second.erase(p[2]);
      }
      SendAll(fd, ":" + std::to_string(n) + "\n");
    } else if (cmd == "DEL" && p.size() >= 2) {
      {
        std::lock_guard<std::mutex> lk(g_mu);
        g_streams.erase(p[1]);
        g_shed.erase(p[1]);
        g_hashes.erase(p[1]);
        g_hash_times.erase(p[1]);
        g_hash_fifo.erase(p[1]);
      }
      SendAll(fd, "+OK\n");
    } else {
      SendAll(fd, "-ERR unknown command\n");
    }
    {
      std::lock_guard<std::mutex> lk(g_mu);
      if (g_shutdown) break;
    }
  }
  close(fd);
}

}  // namespace

int main(int argc, char** argv) {
  int port = argc > 1 ? atoi(argv[1]) : 6399;
  if (argc > 2) g_hash_ttl_ms = atoll(argv[2]);
  // joinable (not detached): a detached sweeper would race static
  // destruction of g_mu/g_cv at shutdown (UB)
  std::thread sweeper(SweeperLoop);
  int srv = socket(AF_INET, SOCK_STREAM, 0);
  g_srv_fd = srv;
  int one = 1;
  setsockopt(srv, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  auto fail = [&sweeper](const char* what) {
    perror(what);
    {
      std::lock_guard<std::mutex> lk(g_mu);
      g_shutdown = true;
    }
    g_cv.notify_all();
    sweeper.join();  // a joinable thread's destructor would std::terminate
    return 1;
  };
  if (bind(srv, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0)
    return fail("bind");
  if (listen(srv, 64) != 0) return fail("listen");
  // readiness handshake for the launcher
  fprintf(stdout, "READY %d\n", port);
  fflush(stdout);
  while (true) {
    int fd = accept(srv, nullptr, nullptr);
    {
      std::lock_guard<std::mutex> lk(g_mu);
      if (g_shutdown) { if (fd >= 0) close(fd); break; }
    }
    if (fd < 0) {
      std::lock_guard<std::mutex> lk(g_mu);
      if (g_shutdown) break;
      continue;
    }
    // detached: connections are short-lived client sessions; keeping a
    // growing vector of finished threads would leak
    std::thread(HandleConn, fd).detach();
  }
  close(srv);
  {
    std::lock_guard<std::mutex> lk(g_mu);
    g_shutdown = true;
  }
  g_cv.notify_all();
  sweeper.join();
  return 0;
}
