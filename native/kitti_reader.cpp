// Native KITTI I/O runtime: velodyne .bin reading + multithreaded
// prefetching batch loader, and the scanline unfiltering of the
// camera's 8-bit grayscale PNG frames.
//
// Native equivalent of the host-side data path the reference gets
// from ROS + PCL (pointcloud deserialization in the TCPROS transport
// and the pcl::PointCloud container).  The hot path here is feeding the
// accelerator:
// a KITTI velodyne scan is ~1.9 MB of float32 (x, y, z, intensity)
// quadruples; this library memory-maps / streams them into
// caller-provided padded buffers and runs a small reader thread pool so
// the host never stalls the device pipeline.
//
// Build: see native/Makefile (g++ -O3 -shared -fPIC, no dependencies
// beyond the C++17 standard library + pthreads).
// Python binding: mono_lidar_depth_tpu/io/native.py (ctypes).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// Read one velodyne .bin file (float32 x,y,z,intensity records).
// Writes at most max_points records into out_xyzi ([max_points * 4]
// floats, row-major) and zero-fills the padding tail.
// Returns the number of points read, or -1 on error.
int64_t mld_read_velodyne(const char* path, float* out_xyzi,
                          int64_t max_points) {
    FILE* f = std::fopen(path, "rb");
    if (f == nullptr) return -1;
    int64_t n = (int64_t)std::fread(out_xyzi, sizeof(float) * 4,
                                    (size_t)max_points, f);
    // Detect truncation-by-max_points vs EOF (drain the remainder).
    std::fclose(f);
    if (n < max_points) {
        std::memset(out_xyzi + n * 4, 0,
                    sizeof(float) * 4 * (size_t)(max_points - n));
    }
    return n;
}

// ---------------------------------------------------------------------
// Prefetching batch loader: a fixed ring of slots filled by worker
// threads in file order; the consumer takes slots in order.
// ---------------------------------------------------------------------

struct Slot {
    std::vector<float> data;    // max_points * 4
    int64_t n_points = 0;
    int64_t index = -1;         // file index this slot holds
    bool ready = false;
};

struct Loader {
    std::vector<std::string> paths;
    int64_t max_points;
    std::vector<Slot> slots;
    std::vector<std::thread> workers;
    std::mutex mu;
    std::condition_variable cv_ready;   // consumer waits
    std::condition_variable cv_free;    // producers wait
    int64_t next_to_schedule = 0;       // next file index to hand a worker
    int64_t next_to_consume = 0;        // next file index the consumer wants
    std::atomic<bool> stop{false};

    int64_t depth() const { return (int64_t)slots.size(); }
};

static void worker_main(Loader* L) {
    for (;;) {
        int64_t idx;
        Slot* slot;
        {
            std::unique_lock<std::mutex> lk(L->mu);
            // Ring-window invariant: file idx may be scheduled once
            // idx - next_to_consume < depth; its slot (idx % depth) is
            // then guaranteed consumed (previous occupant idx - depth
            // precedes next_to_consume).
            L->cv_free.wait(lk, [&] {
                return L->stop.load() ||
                       (L->next_to_schedule < (int64_t)L->paths.size() &&
                        L->next_to_schedule - L->next_to_consume <
                            L->depth());
            });
            if (L->stop.load() ||
                L->next_to_schedule >= (int64_t)L->paths.size())
                return;
            idx = L->next_to_schedule++;
            slot = &L->slots[idx % L->depth()];
            slot->index = idx;
            slot->ready = false;
        }
        slot->n_points = mld_read_velodyne(
            L->paths[(size_t)idx].c_str(), slot->data.data(), L->max_points);
        {
            std::lock_guard<std::mutex> lk(L->mu);
            slot->ready = true;
        }
        L->cv_ready.notify_all();
    }
}

// Create a loader over `count` NUL-separated paths with `depth`
// prefetch slots and `threads` reader threads.
void* mld_loader_create(const char* paths_blob, int64_t count,
                        int64_t max_points, int64_t depth, int64_t threads) {
    Loader* L = new Loader();
    const char* p = paths_blob;
    for (int64_t i = 0; i < count; ++i) {
        L->paths.emplace_back(p);
        p += L->paths.back().size() + 1;
    }
    L->max_points = max_points;
    if (depth < 2) depth = 2;
    if (depth > count && count > 0) depth = count;
    L->slots.resize((size_t)depth);
    for (auto& s : L->slots) s.data.resize((size_t)(max_points * 4));
    if (threads < 1) threads = 1;
    for (int64_t t = 0; t < threads; ++t)
        L->workers.emplace_back(worker_main, L);
    return L;
}

// Blocking: copy the next scan (in file order) into out_xyzi.
// Returns point count, or -2 when the sequence is exhausted, -1 on a
// read error for that file.
int64_t mld_loader_next(void* handle, float* out_xyzi) {
    Loader* L = (Loader*)handle;
    int64_t idx;
    {
        std::unique_lock<std::mutex> lk(L->mu);
        if (L->next_to_consume >= (int64_t)L->paths.size()) return -2;
        idx = L->next_to_consume;
        Slot& s = L->slots[idx % L->depth()];
        L->cv_ready.wait(lk, [&] { return s.ready && s.index == idx; });
        std::memcpy(out_xyzi, s.data.data(),
                    sizeof(float) * 4 * (size_t)L->max_points);
        int64_t n = s.n_points;
        L->next_to_consume++;
        s.ready = false;
        s.index = -2;  // consumed marker; slot reusable
        lk.unlock();
        L->cv_free.notify_all();
        return n;
    }
}

void mld_loader_destroy(void* handle) {
    Loader* L = (Loader*)handle;
    {
        std::lock_guard<std::mutex> lk(L->mu);
        L->stop.store(true);
    }
    L->cv_free.notify_all();
    L->cv_ready.notify_all();
    for (auto& t : L->workers) t.join();
    delete L;
}

// Undo the PNG scanline filters (0-4) of an 8-bit image with one byte
// per pixel.  rows: h scanlines of 1 filter byte + w filtered bytes;
// out: [h * w] pixels.  Paeth and Average rows depend on the pixel to
// the left, so each row is one sequential pass.
// Returns 0, or -1 on a filter type above 4.
int64_t mld_png_unfilter(const uint8_t* rows, int64_t h, int64_t w,
                         uint8_t* out) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t kind = rows[r * (w + 1)];
        const uint8_t* raw = rows + r * (w + 1) + 1;
        uint8_t* x = out + r * w;
        const uint8_t* up = r > 0 ? x - w : nullptr;
        if (kind > 4) return -1;
        for (int64_t i = 0; i < w; ++i) {
            const int a = i > 0 ? x[i - 1] : 0;
            const int b = up ? up[i] : 0;
            const int c = (up && i > 0) ? up[i - 1] : 0;
            int pred = 0;
            if (kind == 1) {
                pred = a;
            } else if (kind == 2) {
                pred = b;
            } else if (kind == 3) {
                pred = (a + b) >> 1;
            } else if (kind == 4) {
                const int pa = std::abs(b - c), pb = std::abs(a - c);
                const int pc = std::abs(a + b - 2 * c);
                pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            }
            x[i] = (uint8_t)(raw[i] + pred);
        }
    }
    return 0;
}

}  // extern "C"
