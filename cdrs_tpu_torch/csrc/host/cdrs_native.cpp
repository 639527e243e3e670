// cdrs_native — the host runtime library of cdrs_tpu_torch (host C++, no
// device code), loaded with ctypes by cdrs_tpu_torch/runtime/native.py and
// built at first use by cdrs_tpu_torch/ops/_build.py with
// g++ -O3 -std=c++20 -fPIC -shared -pthread (no OpenMP runtime is linked:
// a second libgomp beside torch's own OpenMP runtime is a known source of
// crashes and oversubscription):
//
//   * simulate_events — threaded Poisson access-event generation, sorted by
//     timestamp, deterministic per (seed, file) regardless of thread count.
//   * log_write — the access.log CSV writer.
//   * log_fill_chunk / intern_* — chunked access.log CSV reader emitting
//     columnar arrays (epoch seconds, op, offset-indexed path/client byte
//     ranges) plus hash-map string interning, resumable by byte offset.
//
// The same source as the JAX package's native/cdrs_native.cpp but for
// intern_lookup, whose rows split over std::threads instead of an OpenMP
// loop (each id depends only on its own row, so the ids are the same).
// Distributional semantics match sim/access.py (order-statistics Poisson:
// count ~ Poisson(lambda*T), times uniform on [0, T)), with a C++ RNG stream
// (std::mt19937_64) — deterministic, but not NumPy's stream.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Event simulation
// ---------------------------------------------------------------------------

// Phase 1: per-file Poisson event counts.  Returns total events.
// counts_out: int64[n_files]
int64_t sim_counts(int64_t n_files, const double* read_rate,
                   const double* write_rate, double duration, uint64_t seed,
                   int64_t* counts_out) {
  int64_t total = 0;
  for (int64_t i = 0; i < n_files; ++i) {
    std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)i);
    double lam = (read_rate[i] + write_rate[i]) * duration;
    int64_t c = 0;
    if (lam > 0) {
      std::poisson_distribution<int64_t> pois(lam);
      c = pois(rng);
    }
    counts_out[i] = c;
    total += c;
  }
  return total;
}

// Phase 2: fill event arrays (ts, pid, op, client), then sort by timestamp.
// Deterministic per (seed, file): each file's events come from an RNG seeded
// by (seed, i), independent of thread scheduling.  Arrays are caller-
// allocated with the total from sim_counts.
void sim_fill(int64_t n_files, const int64_t* counts, const double* read_rate,
              const double* write_rate, const double* locality,
              const int32_t* primary_node, const int32_t* client_pool,
              int64_t n_pool, double duration, double sim_start, uint64_t seed,
              int64_t n_threads, double* ts_out, int32_t* pid_out,
              int8_t* op_out, int32_t* client_out) {
  std::vector<int64_t> offsets(n_files + 1, 0);
  for (int64_t i = 0; i < n_files; ++i) offsets[i + 1] = offsets[i] + counts[i];
  const int64_t total = offsets[n_files];

  if (n_threads <= 0) {
    n_threads = (int64_t)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }

  std::atomic<int64_t> next_file(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next_file.fetch_add(1);
      if (i >= n_files) return;
      // Re-seed as in sim_counts and discard the count draw (same
      // distribution + same engine state consume the same variates), so the
      // fill stream continues deterministically after it.
      std::mt19937_64 rng(seed * 0x9E3779B97F4A7C15ULL + (uint64_t)i);
      double lam = (read_rate[i] + write_rate[i]) * duration;
      if (lam > 0) {
        std::poisson_distribution<int64_t> pois(lam);
        (void)pois(rng);
      }
      std::uniform_real_distribution<double> uni(0.0, 1.0);
      const double p_read =
          read_rate[i] / (read_rate[i] + write_rate[i] + 1e-12);
      const double loc = locality[i];
      const int32_t prim = primary_node[i];
      for (int64_t j = offsets[i]; j < offsets[i + 1]; ++j) {
        ts_out[j] = sim_start + uni(rng) * duration;
        pid_out[j] = (int32_t)i;
        op_out[j] = uni(rng) >= p_read ? 1 : 0;  // 1 = WRITE
        if (n_pool <= 0 || uni(rng) < loc) {
          client_out[j] = prim;
        } else {
          client_out[j] = client_pool[(int64_t)(uni(rng) * (double)n_pool) %
                                      n_pool];
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  // Global time sort (reference: access_simulator.py:60).  An index
  // permutation + per-column gathers is cache-hostile at 1B events (every
  // comparison and every gather is a random read across a 17 GB working
  // set); instead: pack rows into 24 B structs, scatter them into time
  // buckets (sequential read, ~4K append streams), stable-sort each small
  // bucket by ts, and unpack sequentially.  Bucket append preserves input
  // order and the per-bucket sort is stable, so ties keep the original
  // (file-major) order — identical output to the stable index sort.
  struct Ev {
    double ts;
    int32_t pid;
    int32_t client;
    int8_t op;
  };
  const int64_t n_buckets =
      std::max<int64_t>(1, std::min<int64_t>(4096, total >> 18));
  std::vector<int64_t> bucket_pos(n_buckets + 1, 0);
  const double inv_span = duration > 0 ? (double)n_buckets / duration : 0.0;
  auto bucket_of = [&](double t) {
    int64_t b = (int64_t)((t - sim_start) * inv_span);
    return b < 0 ? 0 : (b >= n_buckets ? n_buckets - 1 : b);
  };
  for (int64_t i = 0; i < total; ++i) ++bucket_pos[bucket_of(ts_out[i]) + 1];
  for (int64_t b = 0; b < n_buckets; ++b) bucket_pos[b + 1] += bucket_pos[b];
  // Scatter straight from the column arrays — one 24 B/event temporary
  // (binned), not two; at 1B events that is the difference between ~24 GB
  // and ~48 GB of staging.
  std::vector<Ev> binned(total);
  {
    std::vector<int64_t> cur(bucket_pos.begin(), bucket_pos.end() - 1);
    for (int64_t i = 0; i < total; ++i)
      binned[cur[bucket_of(ts_out[i])]++] =
          Ev{ts_out[i], pid_out[i], client_out[i], op_out[i]};
  }

  std::atomic<int64_t> next_bucket(0);
  auto sort_worker = [&]() {
    for (;;) {
      int64_t b = next_bucket.fetch_add(1);
      if (b >= n_buckets) return;
      std::stable_sort(binned.begin() + bucket_pos[b],
                       binned.begin() + bucket_pos[b + 1],
                       [](const Ev& a, const Ev& c) { return a.ts < c.ts; });
    }
  };
  threads.clear();
  for (int64_t t = 0; t < n_threads; ++t) threads.emplace_back(sort_worker);
  for (auto& t : threads) t.join();

  for (int64_t i = 0; i < total; ++i) {
    ts_out[i] = binned[i].ts;
    pid_out[i] = binned[i].pid;
    client_out[i] = binned[i].client;
    op_out[i] = binned[i].op;
  }
}

// ---------------------------------------------------------------------------
// access.log CSV parsing
// ---------------------------------------------------------------------------

// days-from-civil (Howard Hinnant's public-domain algorithm shape): epoch days
// for a proleptic Gregorian date.
static int64_t days_from_civil(int64_t y, int64_t m, int64_t d) {
  y -= m <= 2;
  const int64_t era = (y >= 0 ? y : y - 399) / 400;
  const int64_t yoe = y - era * 400;
  const int64_t doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const int64_t doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return era * 146097 + doe - 719468;
}

// Parse "YYYY-MM-DDTHH:MM:SS[.frac][Z|+HH:MM|-HH:MM]" -> epoch seconds.
// Returns NaN on malformed input (matching Python parse_iso_ts's accepted
// grammar; naive stamps are treated as UTC).
static double parse_iso(const char* s, int64_t len) {
  if (len < 19) return __builtin_nan("");
  auto num = [&](int64_t off, int64_t n) {
    int64_t v = 0;
    for (int64_t i = 0; i < n; ++i) {
      char c = s[off + i];
      if (c < '0' || c > '9') return (int64_t)-1;
      v = v * 10 + (c - '0');
    }
    return v;
  };
  int64_t Y = num(0, 4), M = num(5, 2), D = num(8, 2);
  int64_t h = num(11, 2), m = num(14, 2), sec = num(17, 2);
  if (Y < 0 || M < 0 || D < 0 || h < 0 || m < 0 || sec < 0)
    return __builtin_nan("");
  double frac = 0.0;
  int64_t i = 19;
  if (i < len && s[i] == '.') {
    double scale = 0.1;
    for (++i; i < len && s[i] >= '0' && s[i] <= '9'; ++i) {
      frac += (s[i] - '0') * scale;
      scale *= 0.1;
    }
  }
  double tz_off = 0.0;
  if (i < len) {
    if (s[i] == 'Z' && i + 1 == len) {
      // UTC marker
    } else if ((s[i] == '+' || s[i] == '-') && len - i >= 6 && s[i + 3] == ':') {
      int64_t oh = num(i + 1, 2), om = num(i + 4, 2);
      if (oh < 0 || om < 0 || len - i != 6) return __builtin_nan("");
      tz_off = (double)(oh * 3600 + om * 60) * (s[i] == '+' ? 1.0 : -1.0);
    } else {
      return __builtin_nan("");  // trailing junk -> python fallback
    }
  }
  return (double)(days_from_civil(Y, M, D) * 86400 + h * 3600 + m * 60 + sec) +
         frac - tz_off;
}

// ---------------------------------------------------------------------------
// Log writing (the inverse of ingestion — emitting the access.log format
// without a per-row Python loop)
// ---------------------------------------------------------------------------

// Inverse of days_from_civil (Hinnant's civil_from_days shape).
static void civil_from_days(int64_t z, int64_t* y, int64_t* m, int64_t* d) {
  z += 719468;
  const int64_t era = (z >= 0 ? z : z - 146096) / 146097;
  const int64_t doe = z - era * 146097;
  const int64_t yoe = (doe - doe / 1460 + doe / 36524 - doe / 146096) / 365;
  const int64_t doy = doe - (365 * yoe + yoe / 4 - yoe / 100);
  const int64_t mp = (5 * doy + 2) / 153;
  *d = doy - (153 * mp + 2) / 5 + 1;
  *m = mp + (mp < 10 ? 3 : -9);
  *y = yoe + era * 400 + (*m <= 2);
}

// Append `n` rows "iso_ts,path,op,client,pid" to `path`.  Timestamps are
// formatted with millisecond precision + 'Z' (reference:
// src/access_simulator.py:5-6).  Paths/clients come as blob+offset string
// tables indexed by pid/client.  Returns rows written, -1 on IO error.
int64_t log_write(const char* path, int64_t n, const double* ts,
                  const int32_t* pid, const int8_t* op, const int32_t* client,
                  const char* pblob, const int64_t* poff,
                  const char* cblob, const int64_t* coff,
                  int64_t append) {
  FILE* f = std::fopen(path, append ? "ab" : "wb");
  if (!f) return -1;
  std::vector<char> buf(1 << 22);
  size_t pos = 0;
  // The stream is time-sorted, so consecutive rows usually share the whole
  // second: cache the formatted "YYYY-MM-DDTHH:MM:SS." prefix per second
  // (snprintf per row would be the writer's bottleneck).
  int64_t last_whole = INT64_MIN;
  char datebuf[32];
  int datelen = 0;
  for (int64_t i = 0; i < n; ++i) {
    // The path/client blob reads are random across a multi-MB table (pids
    // are time-ordered, i.e. shuffled): prefetch a few rows ahead so the
    // misses overlap the formatting work.
    if (i + 8 < n) {
      __builtin_prefetch(&poff[pid[i + 8]]);
      __builtin_prefetch(&coff[client[i + 8]]);
    }
    if (i + 4 < n) {
      __builtin_prefetch(pblob + poff[pid[i + 4]]);
      __builtin_prefetch(cblob + coff[client[i + 4]]);
    }
    double t = ts[i];
    int64_t whole = (int64_t)t;
    if ((double)whole > t) --whole;               // floor for negative ts
    // Truncate to ms (no rounding) — byte-identical to the python
    // fallback writer, which computes (t - floor(t)) * 1000.0 and
    // truncates with the same IEEE double ops.
    int64_t ms = (int64_t)((t - (double)whole) * 1000.0);
    if (ms > 999) ms = 999;
    if (whole != last_whole) {
      int64_t days = whole / 86400;
      int64_t sod = whole - days * 86400;
      if (sod < 0) { sod += 86400; --days; }
      int64_t Y, M, D;
      civil_from_days(days, &Y, &M, &D);
      datelen = std::snprintf(
          datebuf, sizeof(datebuf), "%04lld-%02lld-%02lldT%02lld:%02lld:%02lld.",
          (long long)Y, (long long)M, (long long)D,
          (long long)(sod / 3600), (long long)((sod / 60) % 60),
          (long long)(sod % 60));
      last_whole = whole;
    }
    const int64_t p = pid[i], c = client[i];
    const int64_t plen = poff[p + 1] - poff[p];
    const int64_t clen = coff[c + 1] - coff[c];
    // row: ts(datelen+5), path, op(<=5), client, pid(4) + separators
    if (pos + (size_t)datelen + (size_t)plen + (size_t)clen + 32 > buf.size()) {
      if (std::fwrite(buf.data(), 1, pos, f) != pos) { std::fclose(f); return -1; }
      pos = 0;
    }
    std::memcpy(buf.data() + pos, datebuf, (size_t)datelen);
    pos += (size_t)datelen;
    buf[pos++] = (char)('0' + ms / 100);
    buf[pos++] = (char)('0' + (ms / 10) % 10);
    buf[pos++] = (char)('0' + ms % 10);
    buf[pos++] = 'Z';
    buf[pos++] = ',';
    std::memcpy(buf.data() + pos, pblob + poff[p], (size_t)plen); pos += (size_t)plen;
    buf[pos++] = ',';
    if (op[i]) { std::memcpy(buf.data() + pos, "WRITE", 5); pos += 5; }
    else { std::memcpy(buf.data() + pos, "READ", 4); pos += 4; }
    buf[pos++] = ',';
    std::memcpy(buf.data() + pos, cblob + coff[c], (size_t)clen); pos += (size_t)clen;
    buf[pos++] = ',';
    int64_t tag = 1000 + i % 9000;                // always 4 digits
    buf[pos++] = (char)('0' + tag / 1000);
    buf[pos++] = (char)('0' + (tag / 100) % 10);
    buf[pos++] = (char)('0' + (tag / 10) % 10);
    buf[pos++] = (char)('0' + tag % 10);
    buf[pos++] = '\n';
  }
  if (pos && std::fwrite(buf.data(), 1, pos, f) != pos) { std::fclose(f); return -1; }
  std::fclose(f);
  return n;
}

// ---------------------------------------------------------------------------
// Chunked log ingestion (streaming; the 1B-event feed must never be resident)
// ---------------------------------------------------------------------------

// Single-pass chunk parser: parse up to max_rows complete rows starting at
// byte `offset`, stopping early when the path/client blob capacities would
// overflow (the unread row starts at *next_offset — the caller simply issues
// the next chunk from there).  Returns rows parsed; -1 on IO error; -2 when
// a row uses CSV quoting; -3 when a non-empty row has fewer than 4 fields
// (for -2/-3, *next_offset is the offending row's start so the caller can
// resume with the python csv parser from that exact byte).
int64_t log_fill_chunk(const char* path, int64_t offset, int64_t max_rows,
                       int64_t path_cap, int64_t client_cap,
                       double* ts_out, int8_t* op_out,
                       char* path_blob, int64_t* path_off,
                       char* client_blob, int64_t* client_off,
                       int64_t* next_offset) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  if (offset > 0 && std::fseek(f, (long)offset, SEEK_SET) != 0) {
    std::fclose(f);
    return -1;
  }
  int64_t row = 0, ppos = 0, cpos = 0;
  int64_t line_start = offset;   // absolute byte offset of the current line
  int64_t consumed = offset;     // absolute offset just past the last row taken
  int err = 0;                   // 0 ok, -2 quoted, -3 malformed
  bool full = false;             // max_rows or caps reached
  std::vector<char> buf(1 << 20);
  std::string carry;
  size_t got;

  // Returns false when the chunk must stop (full or error).
  auto handle = [&](const char* s, size_t len, int64_t abs_end) -> bool {
    if (len == 0) { consumed = abs_end; return true; }
    if (row >= max_rows) { full = true; return false; }
    if (memchr(s, '"', len)) { err = -2; return false; }
    const char* c1 = (const char*)memchr(s, ',', len);
    const char* c2 = c1 ? (const char*)memchr(c1 + 1, ',', len - (c1 + 1 - s)) : nullptr;
    const char* c3 = c2 ? (const char*)memchr(c2 + 1, ',', len - (c2 + 1 - s)) : nullptr;
    if (!c3) { err = -3; return false; }
    const char* c4 = (const char*)memchr(c3 + 1, ',', len - (c3 + 1 - s));
    const char* end4 = c4 ? c4 : s + len;
    int64_t plen = (int64_t)(c2 - c1 - 1);
    int64_t clen = (int64_t)(end4 - c3 - 1);
    if (ppos + plen > path_cap || cpos + clen > client_cap) {
      full = true;   // next chunk starts at this row
      return false;
    }
    ts_out[row] = parse_iso(s, c1 - s);
    std::memcpy(path_blob + ppos, c1 + 1, (size_t)plen);
    ppos += plen;
    op_out[row] = (c3 - c2 - 1 == 5 && std::memcmp(c2 + 1, "WRITE", 5) == 0)
                      ? 1 : 0;
    std::memcpy(client_blob + cpos, c3 + 1, (size_t)clen);
    cpos += clen;
    ++row;
    path_off[row] = ppos;
    client_off[row] = cpos;
    consumed = abs_end;
    return true;
  };

  path_off[0] = 0;
  client_off[0] = 0;
  int64_t file_pos = offset;
  bool stop = false;
  while (!stop && (got = std::fread(buf.data(), 1, buf.size(), f)) > 0) {
    size_t start = 0;
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] != '\n') continue;
      int64_t abs_end = file_pos + (int64_t)i + 1;
      bool ok;
      if (!carry.empty()) {
        carry.append(buf.data() + start, i - start);
        ok = handle(carry.data(), carry.size(), abs_end);
        carry.clear();
      } else {
        ok = handle(buf.data() + start, i - start, abs_end);
      }
      if (!ok) { stop = true; break; }
      start = i + 1;
      line_start = abs_end;
    }
    if (!stop) carry.append(buf.data() + start, got - start);
    file_pos += (int64_t)got;
  }
  if (!stop && !carry.empty()) {
    // Final line without a trailing newline.
    handle(carry.data(), carry.size(), file_pos);
  }
  std::fclose(f);
  if (err) { *next_offset = line_start; return err; }
  *next_offset = consumed;
  return row;
}

// ---------------------------------------------------------------------------
// Native string interning — path -> id lookups without a Python row loop
// ---------------------------------------------------------------------------

// Open-addressing hash table with software-prefetched probes.  At 1M+
// interned paths every probe is a cold cache miss; a
// flat power-of-two table of (hash64, id) slots needs ONE miss per probe
// instead of unordered_map's bucket + node + heap-string chain, and
// batched __builtin_prefetch hides even that one behind neighbouring rows.
// Full 64-bit hashes are stored so a slot mismatch almost never touches the
// key bytes; equal hashes still verify against the interned string (ids
// index `names`, insertion order — the exported vocabulary is unchanged).

static inline uint64_t hash_key(const char* s, size_t len) {
  // FNV-1a 64 with an avalanche finalizer (splitmix64) — cheap, and the
  // finalizer fixes FNV's weak high bits for power-of-two masking.
  uint64_t h = 1469598103934665603ull;
  for (size_t i = 0; i < len; ++i) {
    h ^= (unsigned char)s[i];
    h *= 1099511628211ull;
  }
  h ^= h >> 30; h *= 0xbf58476d1ce4e5b9ull;
  h ^= h >> 27; h *= 0x94d049bb133111ebull;
  h ^= h >> 31;
  return h ? h : 1;  // 0 marks an empty slot
}

struct Slot {
  uint64_t h;   // 0 = empty
  int32_t id;
};

struct InternMap {
  std::vector<Slot> slots;          // one cache line covers hash AND id
  std::vector<std::string> names;   // id -> string (insertion order)
  uint64_t mask = 0;

  void rehash(size_t want) {
    size_t cap = 64;
    while (cap < want * 2) cap <<= 1;   // load factor <= 0.5
    std::vector<Slot> ns(cap, Slot{0, -1});
    uint64_t nm = cap - 1;
    for (const Slot& s : slots) {
      if (!s.h) continue;
      uint64_t j = s.h & nm;
      while (ns[j].h) j = (j + 1) & nm;
      ns[j] = s;
    }
    slots.swap(ns);
    mask = nm;
  }

  // Returns the slot holding `key`, or the empty slot where it belongs.
  inline uint64_t probe(uint64_t h, const char* key, size_t len) const {
    uint64_t j = h & mask;
    while (slots[j].h) {
      if (slots[j].h == h) {
        const std::string& nm = names[(size_t)slots[j].id];
        if (nm.size() == len && std::memcmp(nm.data(), key, len) == 0)
          return j;
      }
      j = (j + 1) & mask;
    }
    return j;
  }

  // Deduplicating insert (the growing client-vocabulary path).
  int32_t insert(const char* key, size_t len) {
    if ((names.size() + 1) * 2 > slots.size()) rehash(names.size() + 1);
    uint64_t h = hash_key(key, len);
    uint64_t j = probe(h, key, len);
    if (slots[j].h) return slots[j].id;
    int32_t id = (int32_t)names.size();
    slots[j] = Slot{h, id};
    names.emplace_back(key, len);
    return id;
  }
};

// Build an intern map from a byte blob + (n+1) offsets.  Ids are POSITIONS:
// names keeps all n entries (even duplicates) so exported vocabularies and
// intern_size match the input exactly; a duplicate key looks up its FIRST
// position (the unordered_map emplace semantics this table replaced).
void* intern_build(const char* blob, const int64_t* off, int64_t n) {
  auto* h = new InternMap();
  h->rehash((size_t)n + 1);
  h->names.reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    const char* key = blob + off[i];
    const size_t len = (size_t)(off[i + 1] - off[i]);
    h->names.emplace_back(key, len);
    uint64_t hk = hash_key(key, len);
    uint64_t j = h->probe(hk, key, len);
    if (!h->slots[j].h) h->slots[j] = Slot{hk, (int32_t)i};
  }
  return h;
}

void intern_free(void* handle) { delete (InternMap*)handle; }

int64_t intern_size(void* handle) {
  return (int64_t)((InternMap*)handle)->names.size();
}

// out[i] = id of blob[off[i]:off[i+1]] in the map, or -1 when absent.
void intern_lookup(void* handle, const char* blob, const int64_t* off,
                   int64_t n, int32_t* out) {
  auto& m = *(InternMap*)handle;
  // Software-pipelined blocks: hash a block of keys and prefetch their
  // first slots, then probe — the table spills cache at 1M entries, so
  // overlapping the misses is worth ~2x on a single core.  Above 65,536
  // rows the blocks split over threads in contiguous ranges; the map is
  // only read here, so the ids do not depend on the split.
  constexpr int64_t B = 16;
  auto run = [&](int64_t lo, int64_t hi_all) {
    for (int64_t base = lo; base < hi_all; base += B) {
      const int64_t hi = base + B < hi_all ? base + B : hi_all;
      uint64_t hs[B];
      for (int64_t i = base; i < hi; ++i) {
        hs[i - base] = hash_key(blob + off[i], (size_t)(off[i + 1] - off[i]));
        __builtin_prefetch(&m.slots[hs[i - base] & m.mask]);
      }
      for (int64_t i = base; i < hi; ++i) {
        const char* key = blob + off[i];
        const size_t len = (size_t)(off[i + 1] - off[i]);
        uint64_t j = m.probe(hs[i - base], key, len);
        out[i] = m.slots[j].h ? m.slots[j].id : -1;
      }
    }
  };
  int64_t n_threads = (int64_t)std::thread::hardware_concurrency();
  if (n_threads <= 0) n_threads = 1;
  n_threads = std::min<int64_t>(n_threads, (n + 65535) / 65536);
  if (n <= 65536 || n_threads <= 1) {
    run(0, n);
    return;
  }
  // Range bounds on block multiples, so every thread's blocks are whole.
  const int64_t blocks = (n + B - 1) / B;
  const int64_t per = (blocks + n_threads - 1) / n_threads;
  std::vector<std::thread> threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    const int64_t lo = std::min<int64_t>(n, t * per * B);
    const int64_t hi = std::min<int64_t>(n, (t + 1) * per * B);
    if (lo < hi) threads.emplace_back(run, lo, hi);
  }
  for (auto& t : threads) t.join();
}

// Like intern_lookup, but unseen keys are INSERTED with the next id (growing
// vocabulary — the client-node interning path).  Returns the map size after.
int64_t intern_insert_lookup(void* handle, const char* blob,
                             const int64_t* off, int64_t n, int32_t* out) {
  auto* h = (InternMap*)handle;
  for (int64_t i = 0; i < n; ++i)
    out[i] = h->insert(blob + off[i], (size_t)(off[i + 1] - off[i]));
  return (int64_t)h->names.size();
}

// Total bytes of names[start:] — sizes the export blob.
int64_t intern_export_bytes(void* handle, int64_t start) {
  auto& names = ((InternMap*)handle)->names;
  int64_t total = 0;
  for (size_t i = (size_t)start; i < names.size(); ++i)
    total += (int64_t)names[i].size();
  return total;
}

// Export names[start:] as a blob + (count+1) offsets (insertion order).
void intern_export(void* handle, int64_t start, char* blob, int64_t* off) {
  auto& names = ((InternMap*)handle)->names;
  int64_t pos = 0, j = 0;
  off[0] = 0;
  for (size_t i = (size_t)start; i < names.size(); ++i) {
    std::memcpy(blob + pos, names[i].data(), names[i].size());
    pos += (int64_t)names[i].size();
    off[++j] = pos;
  }
}

}  // extern "C"
