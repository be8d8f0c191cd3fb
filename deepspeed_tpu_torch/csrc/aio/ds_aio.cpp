// ds_aio — asynchronous file IO engine for tensor swapping.
//
// The port's copy of deepspeed_tpu/csrc/aio/ds_aio.cpp: the host side of
// the reference's AsyncIO extension (ref: csrc/aio/common/
// deepspeed_aio_common.cpp + py_lib/deepspeed_py_aio_handle.cpp — libaio
// O_DIRECT read/write handles that back ZeRO-Infinity NVMe swapping).  The
// swap targets are the host's local disks; this engine uses a pthread pool
// issuing positional pread/pwrite in block_size chunks (optionally
// O_DIRECT) — the same handle semantics (submit N requests, overlap with
// compute, wait for drain) without the libaio dependency.  It is built with
// g++ at first use (deepspeed_tpu_torch/ops/op_builder/builder.py).
//
// C ABI (consumed via ctypes from ops/aio):
//   aio_handle_new(block_size, queue_depth, n_threads, use_o_direct)
//   aio_pread(h, buf, path, offset, nbytes)   -> 0 on submit
//   aio_pwrite(h, buf, path, offset, nbytes)  -> 0 on submit
//   aio_wait(h)          -> number of requests completed since last wait,
//                           or negative errno of the first failed request
//   aio_pending(h)       -> requests not yet completed
//   aio_file_size(path)  -> size or -errno
//   aio_handle_free(h)
//
// A request writes/reads the WHOLE [offset, offset+nbytes) range in
// block_size chunks on one worker thread; distinct requests run on
// distinct threads (queue_depth bounds the submission queue).

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

struct Request {
    bool is_read;
    void* buf;
    std::string path;
    long long offset;
    long long nbytes;
};

struct Handle {
    long long block_size;
    size_t queue_depth;
    bool o_direct;

    std::vector<std::thread> workers;
    std::deque<Request> queue;
    std::mutex mu;
    std::condition_variable cv_submit;   // signalled when queue has room / shutdown
    std::condition_variable cv_worker;   // signalled when work arrives
    std::condition_variable cv_done;     // signalled when a request completes
    std::atomic<long long> in_flight{0};
    std::atomic<long long> completed{0};
    std::atomic<int> first_error{0};
    bool shutdown = false;

    explicit Handle(long long bs, size_t qd, int threads, bool direct)
        : block_size(bs), queue_depth(qd), o_direct(direct) {
        for (int i = 0; i < threads; ++i) workers.emplace_back([this] { run(); });
    }

    ~Handle() {
        {
            std::lock_guard<std::mutex> g(mu);
            shutdown = true;
        }
        cv_worker.notify_all();
        for (auto& t : workers) t.join();
    }

    int submit(Request r) {
        std::unique_lock<std::mutex> lk(mu);
        cv_submit.wait(lk, [this] { return queue.size() < queue_depth || shutdown; });
        if (shutdown) return -1;
        in_flight.fetch_add(1);
        queue.push_back(std::move(r));
        cv_worker.notify_one();
        return 0;
    }

    void run() {
        for (;;) {
            Request r;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_worker.wait(lk, [this] { return !queue.empty() || shutdown; });
                if (shutdown && queue.empty()) return;
                r = std::move(queue.front());
                queue.pop_front();
                cv_submit.notify_one();
            }
            int err = execute(r);
            if (err != 0) {
                int expected = 0;
                first_error.compare_exchange_strong(expected, err);
            }
            {
                // decrement + notify under the mutex: a waiter that checked
                // the predicate just before this decrement must not miss the
                // wakeup (classic lost-wakeup race)
                std::lock_guard<std::mutex> g(mu);
                in_flight.fetch_sub(1);
                completed.fetch_add(1);
                cv_done.notify_all();
            }
        }
    }

    int execute(const Request& r) {
        int flags = r.is_read ? O_RDONLY : (O_WRONLY | O_CREAT);
#ifdef O_DIRECT
        if (o_direct) flags |= O_DIRECT;
#endif
        int fd = ::open(r.path.c_str(), flags, 0644);
        if (fd < 0 && o_direct) {  // O_DIRECT unsupported (e.g. tmpfs): retry buffered
#ifdef O_DIRECT
            fd = ::open(r.path.c_str(), flags & ~O_DIRECT, 0644);
#endif
        }
        if (fd < 0) return -errno;
        long long done = 0;
        int err = 0;
        char* p = static_cast<char*>(r.buf);
        while (done < r.nbytes) {
            long long chunk = r.nbytes - done;
            if (chunk > block_size) chunk = block_size;
            ssize_t n = r.is_read ? ::pread(fd, p + done, chunk, r.offset + done)
                                  : ::pwrite(fd, p + done, chunk, r.offset + done);
            if (n < 0) { err = -errno; break; }
            if (n == 0) { err = -EIO; break; }  // unexpected EOF on read
            done += n;
        }
        ::close(fd);
        return err;
    }

    long long wait_all() {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [this] { return in_flight.load() == 0; });
        long long n = completed.exchange(0);
        int err = first_error.exchange(0);
        return err != 0 ? (long long)err : n;
    }
};

}  // namespace

extern "C" {

void* aio_handle_new(long long block_size, long long queue_depth, int n_threads, int use_o_direct) {
    if (block_size <= 0) block_size = 1 << 20;
    if (queue_depth <= 0) queue_depth = 32;
    if (n_threads <= 0) n_threads = 4;
    return new Handle(block_size, (size_t)queue_depth, n_threads, use_o_direct != 0);
}

void aio_handle_free(void* h) { delete static_cast<Handle*>(h); }

int aio_pread(void* h, void* buf, const char* path, long long offset, long long nbytes) {
    return static_cast<Handle*>(h)->submit(Request{true, buf, path, offset, nbytes});
}

int aio_pwrite(void* h, const void* buf, const char* path, long long offset, long long nbytes) {
    return static_cast<Handle*>(h)->submit(
        Request{false, const_cast<void*>(buf), path, offset, nbytes});
}

long long aio_wait(void* h) { return static_cast<Handle*>(h)->wait_all(); }

long long aio_pending(void* h) { return static_cast<Handle*>(h)->in_flight.load(); }

long long aio_file_size(const char* path) {
    struct stat st;
    if (::stat(path, &st) != 0) return -(long long)errno;
    return (long long)st.st_size;
}

}  // extern "C"
