// hvd_core — the native control plane of horovod_tpu_torch.
//
// A copy of horovod_tpu/core/native/hvd_core.cc (ABI version 1), the
// rebuild of the reference Horovod's C++ control logic (mpi_ops.cc) without
// its transport: the data plane is torch.distributed (NCCL or gloo), so what
// stays native is the control plane:
//
//  * the name-keyed request table with per-rank submission counting
//    (IncrementTensorCount, mpi_ops.cc:341-366) and cross-rank validation
//    (ConstructMPIResponse, mpi_ops.cc:374-592) — error messages byte-match
//    analysis/protocol.py::validate_requests, the Python path;
//  * the tensor-fusion planner (response merging, mpi_ops.cc:1604-1637);
//  * stall detection (CheckForStalledTensors, mpi_ops.cc:1369-1412);
//  * the Chrome-tracing timeline writer (timeline.h/.cc state machine:
//    per-tensor pid, NEGOTIATING / ACTIVITY phases, periodic flush).
//
// A plain C API bound from Python with ctypes (core/native/__init__.py).
//
// Build: g++ -std=c++17 -O2 -fPIC -shared (core/native/__init__.py builds
// it at first use).

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <mutex>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

enum OpType : int {
  OP_ALLREDUCE = 0,
  OP_ALLGATHER = 1,
  OP_BROADCAST = 2,
  OP_GATHER = 3,
  OP_ALLTOALL = 4,  // extension beyond the fork (upstream Horovod 0.19 API)
  OP_REDUCESCATTER = 5,  // extension beyond the fork (upstream 0.27 API)
};

const char* OpLower(int op) {
  switch (op) {
    case OP_ALLREDUCE: return "allreduce";
    case OP_ALLGATHER: return "allgather";
    case OP_BROADCAST: return "broadcast";
    case OP_GATHER: return "gather";
    case OP_ALLTOALL: return "alltoall";
    case OP_REDUCESCATTER: return "reducescatter";
    default: return "unknown";
  }
}

double NowSeconds() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

int64_t NowMicros() {
  return std::chrono::duration_cast<std::chrono::microseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

std::string DimsStr(const std::vector<long long>& dims) {
  std::ostringstream os;
  os << "[";
  for (size_t i = 0; i < dims.size(); ++i) {
    if (i) os << ", ";
    os << dims[i];
  }
  os << "]";
  return os.str();
}

struct Request {
  int rank;
  int op;
  std::string dtype;
  std::vector<long long> dims;
  int root_rank;
};

struct Entry {
  double first_time = 0.0;  // for stall detection (MessageTable pairs a
                            // timestamp with the requests, mpi_ops.cc:126-129)
  std::vector<Request> reqs;
};

struct Response {
  std::vector<long long> tensor_sizes;  // per-rank first dims
  int root_rank = -1;
  int op = -1;
};

// ---------------------------------------------------------------------------
// Timeline: Chrome tracing (catapult) JSON, the reference's profiler
// (timeline.h:46-87). Each tensor is a fake "process" (pid) with metadata
// events (timeline.cc:63-76); phase events use B/E with µs timestamps
// (timeline.cc:78-92); buffered writes flushed every second
// (timeline.h:35, timeline.cc:94-97).
// ---------------------------------------------------------------------------
class Timeline {
 public:
  bool Start(const std::string& path) {
    std::lock_guard<std::mutex> l(mu_);
    file_.open(path, std::ios::out | std::ios::trunc);
    if (!file_.is_open()) return false;
    file_ << "[\n";
    start_micros_ = NowMicros();
    last_flush_ = NowSeconds();
    active_ = true;
    return true;
  }

  bool active() {
    std::lock_guard<std::mutex> l(mu_);
    return active_;
  }

  void WriteEvent(const std::string& name, char phase,
                  const std::string& tensor, const std::string& args_name) {
    std::lock_guard<std::mutex> l(mu_);
    if (!active_) return;
    int pid = TensorPid(tensor);
    file_ << "{\"name\": \"" << name << "\", \"ph\": \"" << phase
          << "\", \"ts\": " << (NowMicros() - start_micros_)
          << ", \"pid\": " << pid;
    if (phase == 'X') file_ << ", \"dur\": 0";  // instant tick (timeline.cc:86-88)
    if (!args_name.empty())
      file_ << ", \"args\": {\"name\": \"" << args_name << "\"}";
    file_ << "},\n";
    MaybeFlush();
  }

  void Stop() {
    std::lock_guard<std::mutex> l(mu_);
    if (!active_) return;
    file_.flush();
    file_.close();
    active_ = false;
  }

 private:
  // One fake chrome "process" per tensor name with sorted metadata, the
  // reference's scheme (timeline.cc:63-76).
  int TensorPid(const std::string& tensor) {
    auto it = pids_.find(tensor);
    if (it != pids_.end()) return it->second;
    int pid = static_cast<int>(pids_.size()) + 1;
    pids_[tensor] = pid;
    file_ << "{\"name\": \"process_name\", \"ph\": \"M\", \"pid\": " << pid
          << ", \"args\": {\"name\": \"" << tensor << "\"}},\n";
    file_ << "{\"name\": \"process_sort_index\", \"ph\": \"M\", \"pid\": "
          << pid << ", \"args\": {\"sort_index\": " << pid << "}},\n";
    return pid;
  }

  void MaybeFlush() {
    double now = NowSeconds();
    if (now - last_flush_ > 1.0) {  // 1 s flush interval (timeline.h:35)
      file_.flush();
      last_flush_ = now;
    }
  }

  std::mutex mu_;
  std::ofstream file_;
  std::unordered_map<std::string, int> pids_;
  int64_t start_micros_ = 0;
  double last_flush_ = 0.0;
  bool active_ = false;
};

struct GroupState {
  int size = 0;
  std::unordered_map<std::string, Entry> pending;
  std::unordered_map<std::string, Response> ready;
};

struct Core {
  std::mutex mu;
  std::vector<GroupState> groups;
  double stall_seconds = 60.0;
  Timeline timeline;
  std::string last_error;
};

int Fail(Core* c, char* err, int err_len, const std::string& msg) {
  c->last_error = msg;
  if (err && err_len > 0) {
    std::snprintf(err, static_cast<size_t>(err_len), "%s", msg.c_str());
  }
  return -1;
}

// Port of ConstructMPIResponse's cross-rank checks (mpi_ops.cc:374-592).
// Returns empty string when consistent, else the error message (formats
// byte-match horovod_tpu/core/negotiate.py so both paths satisfy the same
// tests).
std::string ValidateEntry(const std::vector<Request>& reqs, int group_size,
                          const std::string& name, Response* out) {
  const Request& first = reqs.front();
  std::ostringstream os;
  for (size_t i = 1; i < reqs.size(); ++i) {
    const Request& r = reqs[i];
    if (r.dtype != first.dtype) {
      os << "Mismatched data types: One or more ranks sent tensors of type "
         << first.dtype << ", but one or more other ranks sent tensors of "
         << "type " << r.dtype << " for tensor " << name << ".";
      return os.str();
    }
    if (r.op != first.op) {
      os << "Mismatched collective operations: One or more ranks did an "
         << OpLower(first.op) << ", but one or more other ranks did an "
         << OpLower(r.op) << " on tensor " << name << ".";
      return os.str();
    }
  }
  if (first.op == OP_ALLTOALL || first.op == OP_REDUCESCATTER) {
    // Uniform shapes + dim-0 divisibility (same contract for both).
    for (size_t i = 1; i < reqs.size(); ++i) {
      if (reqs[i].dims != first.dims) {
        os << "Mismatched " << OpLower(first.op)
           << " tensor shapes: One or more ranks sent "
           << "tensors of shape " << DimsStr(first.dims) << ", but one or "
           << "more other ranks sent tensors of shape "
           << DimsStr(reqs[i].dims) << " on tensor " << name << ".";
        return os.str();
      }
    }
    if (first.dims.empty() ||
        first.dims[0] % static_cast<int64_t>(group_size) != 0) {
      os << "Invalid " << OpLower(first.op)
         << " tensor shape: first dimension of tensor "
         << name << " (" << DimsStr(first.dims) << ") must be divisible by "
         << "the group size " << group_size << ".";
      return os.str();
    }
  } else if (first.op == OP_ALLREDUCE || first.op == OP_BROADCAST) {
    for (size_t i = 1; i < reqs.size(); ++i) {
      if (reqs[i].dims != first.dims) {
        os << "Mismatched " << OpLower(first.op) << " tensor shapes: One or "
           << "more ranks sent tensors of shape " << DimsStr(first.dims)
           << ", but one or more other ranks sent tensors of shape "
           << DimsStr(reqs[i].dims) << " on tensor " << name << ".";
        return os.str();
      }
    }
  } else {  // ALLGATHER / GATHER (mpi_ops.cc:453-517)
    if (first.dims.empty()) {
      os << "Rank zero tried to " << OpLower(first.op)
         << " a rank-zero tensor " << name << ", which is not allowed.";
      return os.str();
    }
    for (size_t i = 1; i < reqs.size(); ++i) {
      const Request& r = reqs[i];
      if (r.dims.size() != first.dims.size()) {
        os << "Mismatched " << OpLower(first.op) << " tensor shapes: One or "
           << "more ranks sent tensors of rank " << first.dims.size()
           << ", but one or more other ranks sent tensors of rank "
           << r.dims.size() << " on tensor " << name << ".";
        return os.str();
      }
      if (!std::equal(first.dims.begin() + 1, first.dims.end(),
                      r.dims.begin() + 1)) {
        os << "Mismatched " << OpLower(first.op) << " tensor shapes: "
           << "trailing dimensions of tensor " << name << " differ between "
           << "ranks (" << DimsStr(first.dims) << " vs " << DimsStr(r.dims)
           << "); only the first dimension may vary.";
        return os.str();
      }
    }
    std::vector<const Request*> by_rank(reqs.size());
    for (const Request& r : reqs) {
      by_rank[static_cast<size_t>(r.rank)] = &r;
    }
    out->tensor_sizes.clear();
    for (const Request* r : by_rank) out->tensor_sizes.push_back(r->dims[0]);
  }
  if (first.op == OP_BROADCAST || first.op == OP_GATHER) {
    for (size_t i = 1; i < reqs.size(); ++i) {
      if (reqs[i].root_rank != first.root_rank) {
        os << "Mismatched " << OpLower(first.op) << " root ranks: One rank "
           << "specified root rank " << first.root_rank << ", but another "
           << "rank specified root rank " << reqs[i].root_rank
           << " for tensor " << name << ".";
        return os.str();
      }
    }
    if (first.root_rank < 0 || first.root_rank >= group_size) {
      os << "Invalid root rank " << first.root_rank << " for tensor " << name
         << " in a group of size " << group_size << ".";
      return os.str();
    }
    out->root_rank = first.root_rank;
  }
  out->op = first.op;
  return "";
}

}  // namespace

extern "C" {

Core* hvd_core_create(int num_groups, const int* group_sizes,
                      double stall_seconds) {
  if (num_groups <= 0 || !group_sizes) return nullptr;
  Core* c = new Core();
  c->groups.resize(static_cast<size_t>(num_groups));
  for (int i = 0; i < num_groups; ++i) {
    if (group_sizes[i] <= 0) {
      delete c;
      return nullptr;
    }
    c->groups[static_cast<size_t>(i)].size = group_sizes[i];
  }
  c->stall_seconds = stall_seconds;
  return c;
}

void hvd_core_destroy(Core* c) {
  if (!c) return;
  c->timeline.Stop();
  delete c;
}

// Submit one rank's request (IncrementTensorCount, mpi_ops.cc:341-366).
// Returns 0 = pending (not all ranks yet), 1 = ready (response constructed
// and retrievable), -1 = validation/usage error (message in err).
int hvd_core_submit(Core* c, int group, const char* name, int op,
                    const char* dtype, int ndim, const long long* dims,
                    int root_rank, int rank, char* err, int err_len) {
  if (!c || !name || !dtype || (ndim > 0 && !dims))
    return Fail(c, err, err_len, "hvd_core_submit: bad arguments.");
  std::lock_guard<std::mutex> l(c->mu);
  if (group < 0 || group >= static_cast<int>(c->groups.size()))
    return Fail(c, err, err_len,
                "Unknown group " + std::to_string(group) + ".");
  GroupState& g = c->groups[static_cast<size_t>(group)];
  if (rank < 0 || rank >= g.size)
    return Fail(c, err, err_len,
                "Rank " + std::to_string(rank) + " out of range for group of "
                "size " + std::to_string(g.size) + ".");
  Entry& e = g.pending[name];
  if (e.reqs.empty()) e.first_time = NowSeconds();
  for (const Request& r : e.reqs) {
    if (r.rank == rank) {
      std::string n(name);
      g.pending.erase(n);
      return Fail(c, err, err_len, "Tensor " + n + " was submitted twice by "
                  "rank " + std::to_string(rank) + ".");
    }
  }
  Request r;
  r.rank = rank;
  r.op = op;
  r.dtype = dtype;
  r.dims.assign(dims, dims + ndim);
  r.root_rank = root_rank;
  if (e.reqs.empty() && c->timeline.active())
    c->timeline.WriteEvent(std::string("NEGOTIATE_") + OpLower(op), 'B', name,
                           "");
  e.reqs.push_back(std::move(r));
  // Per-rank ready tick so a late rank is visible in the trace — the
  // NegotiateRankReady analog (timeline.cc:117-125: an instant 'X' event
  // named by the rank that just landed).
  if (c->timeline.active())
    c->timeline.WriteEvent(std::to_string(rank), 'X', name, "");
  if (static_cast<int>(e.reqs.size()) < g.size) return 0;

  // All ranks in: construct + validate the response (mpi_ops.cc:374-592),
  // erase the entry (the table is per-step, mpi_ops.cc:589).
  Response resp;
  std::string msg = ValidateEntry(e.reqs, g.size, name, &resp);
  g.pending.erase(name);
  if (c->timeline.active())
    c->timeline.WriteEvent(std::string("NEGOTIATE_") + OpLower(op), 'E', name,
                           "");
  if (!msg.empty()) return Fail(c, err, err_len, msg);
  g.ready[name] = std::move(resp);
  return 1;
}

// Fetch the per-rank first-dim sizes of a ready response
// (the MPIResponse tensor_sizes field, mpi_message.h:124-129).
// Returns count written, or -1 if no such response.
int hvd_core_response_sizes(Core* c, int group, const char* name,
                            long long* sizes_out, int max_n) {
  if (!c || !name) return -1;
  std::lock_guard<std::mutex> l(c->mu);
  if (group < 0 || group >= static_cast<int>(c->groups.size())) return -1;
  GroupState& g = c->groups[static_cast<size_t>(group)];
  auto it = g.ready.find(name);
  if (it == g.ready.end()) return -1;
  int n = static_cast<int>(it->second.tensor_sizes.size());
  if (sizes_out) {
    for (int i = 0; i < n && i < max_n; ++i)
      sizes_out[i] = it->second.tensor_sizes[static_cast<size_t>(i)];
  }
  return n;
}

int hvd_core_response_root(Core* c, int group, const char* name) {
  if (!c || !name) return -1;
  std::lock_guard<std::mutex> l(c->mu);
  if (group < 0 || group >= static_cast<int>(c->groups.size())) return -1;
  GroupState& g = c->groups[static_cast<size_t>(group)];
  auto it = g.ready.find(name);
  return it == g.ready.end() ? -1 : it->second.root_rank;
}

// Release a consumed response (PerformOperation pops entries, mpi_ops.cc:759).
void hvd_core_response_done(Core* c, int group, const char* name) {
  if (!c || !name) return;
  std::lock_guard<std::mutex> l(c->mu);
  if (group < 0 || group >= static_cast<int>(c->groups.size())) return;
  c->groups[static_cast<size_t>(group)].ready.erase(name);
}

// Stall report (CheckForStalledTensors, mpi_ops.cc:1369-1412): one line per
// tensor stuck past the window, naming ready + missing ranks. Returns number
// of stalled tensors; report text (newline-separated) written to buf.
int hvd_core_stalled(Core* c, int group, char* buf, int buf_len) {
  if (!c) return -1;
  std::lock_guard<std::mutex> l(c->mu);
  if (group < 0 || group >= static_cast<int>(c->groups.size())) return -1;
  GroupState& g = c->groups[static_cast<size_t>(group)];
  double now = NowSeconds();
  std::ostringstream os;
  int count = 0;
  for (const auto& kv : g.pending) {
    if (now - kv.second.first_time <= c->stall_seconds) continue;
    std::vector<int> ready;
    for (const Request& r : kv.second.reqs) ready.push_back(r.rank);
    std::sort(ready.begin(), ready.end());
    std::vector<bool> have(static_cast<size_t>(g.size), false);
    for (int r : ready) have[static_cast<size_t>(r)] = true;
    if (count) os << "\n";
    os << kv.first << " [ready ranks: [";
    for (size_t i = 0; i < ready.size(); ++i) {
      if (i) os << ", ";
      os << ready[i];
    }
    os << "]] [missing ranks: [";
    bool first = true;
    for (int r = 0; r < g.size; ++r) {
      if (have[static_cast<size_t>(r)]) continue;
      if (!first) os << ", ";
      os << r;
      first = false;
    }
    os << "]]";
    ++count;
  }
  if (buf && buf_len > 0)
    std::snprintf(buf, static_cast<size_t>(buf_len), "%s", os.str().c_str());
  return count;
}

// Fusion planner (mpi_ops.cc:1604-1637 semantics): contiguous same-dtype runs
// capped at threshold bytes; threshold <= 0 means one bucket per tensor.
// bucket_ids_out[i] = bucket index of tensor i. Returns number of buckets.
int hvd_core_plan_fusion(long long threshold, int n, const long long* nbytes,
                         const int* dtype_codes, int* bucket_ids_out) {
  if (n <= 0 || !nbytes || !dtype_codes || !bucket_ids_out) return -1;
  int bucket = -1;
  long long cur_bytes = 0;
  int cur_dtype = -1;
  bool open = false;
  for (int i = 0; i < n; ++i) {
    if (threshold <= 0) {
      bucket_ids_out[i] = ++bucket;
      continue;
    }
    if (!open || dtype_codes[i] != cur_dtype ||
        cur_bytes + nbytes[i] > threshold) {
      ++bucket;
      cur_bytes = 0;
      cur_dtype = dtype_codes[i];
      open = true;
    }
    bucket_ids_out[i] = bucket;
    cur_bytes += nbytes[i];
  }
  return bucket + 1;
}

// --- timeline control (HOROVOD_TIMELINE analog, mpi_ops.cc:1486-1489) ------

int hvd_core_timeline_start(Core* c, const char* path) {
  if (!c || !path) return -1;
  return c->timeline.Start(path) ? 0 : -1;
}

void hvd_core_timeline_stop(Core* c) {
  if (c) c->timeline.Stop();
}

// Generic activity event: phase 'B'/'E'/'i' on a tensor's timeline row —
// carries the reference's activity vocabulary (QUEUE, SCHEDULE,
// MEMCPY_IN_FUSION_BUFFER, XLA_ALLREDUCE, ... ; mpi_ops.cc:794-1346).
void hvd_core_timeline_event(Core* c, const char* tensor, const char* activity,
                             char phase) {
  if (!c || !tensor || !activity) return;
  if (!c->timeline.active()) return;
  c->timeline.WriteEvent(activity, phase, tensor, "");
}

const char* hvd_core_last_error(Core* c) {
  return c ? c->last_error.c_str() : "";
}

int hvd_core_abi_version() { return 1; }

}  // extern "C"
