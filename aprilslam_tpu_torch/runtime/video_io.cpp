// Native video ingestion: Y4M (YUV4MPEG2) reader with a prefetching ring.
//
// The reference's real-camera path leans on OpenCV's C++ VideoCapture for
// file replay (src/detection/video_detection.py:76-110); this is the
// framework's own native reader for the same job: a background thread
// decodes frames ahead of the consumer into a fixed ring of buffers, so
// file I/O overlaps detector compute on the device. Only the luma plane is
// surfaced — the detector consumes grayscale (tag_detector.py:25 converts
// to gray immediately) — and chroma bytes are skipped according to the
// stream's colourspace tag (C420*, C422, C444, Cmono).
//
// C ABI (ctypes-consumed from runtime/__init__.py):
//   vio_open(path, &w, &h, &fps_num, &fps_den) -> handle (0 on error)
//   vio_next(handle, uint8* out)               -> 1 ok, 0 EOF/error
//   vio_close(handle)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <condition_variable>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kRing = 4;

struct Y4MReader {
    FILE* f = nullptr;
    int w = 0, h = 0;
    long fps_num = 30, fps_den = 1;
    size_t luma_bytes = 0;
    size_t chroma_bytes = 0;

    std::vector<std::vector<uint8_t>> ring;
    int head = 0, tail = 0, count = 0;
    bool eof = false, stop = false;
    std::mutex mu;
    std::condition_variable cv_prod, cv_cons;
    std::thread worker;

    ~Y4MReader() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv_prod.notify_all();
        cv_cons.notify_all();
        if (worker.joinable()) worker.join();
        if (f) fclose(f);
    }

    bool parse_header() {
        char line[1024];
        if (!fgets(line, sizeof line, f)) return false;
        if (strncmp(line, "YUV4MPEG2", 9) != 0) return false;
        std::string cspace = "420";
        for (char* tok = strtok(line + 9, " \n"); tok; tok = strtok(nullptr, " \n")) {
            switch (tok[0]) {
                case 'W': w = atoi(tok + 1); break;
                case 'H': h = atoi(tok + 1); break;
                case 'F': {
                    long n = 30, d = 1;
                    if (sscanf(tok + 1, "%ld:%ld", &n, &d) == 2 && d > 0) {
                        fps_num = n;
                        fps_den = d;
                    }
                    break;
                }
                case 'C': cspace = tok + 1; break;
                default: break;  // interlace/aspect/extensions ignored
            }
        }
        if (w <= 0 || h <= 0) return false;
        luma_bytes = size_t(w) * h;
        if (cspace.rfind("420", 0) == 0) chroma_bytes = luma_bytes / 2;
        else if (cspace.rfind("422", 0) == 0) chroma_bytes = luma_bytes;
        else if (cspace.rfind("444", 0) == 0) chroma_bytes = luma_bytes * 2;
        else if (cspace.rfind("mono", 0) == 0) chroma_bytes = 0;
        else return false;
        return true;
    }

    bool read_frame_into(std::vector<uint8_t>& buf) {
        char line[256];
        if (!fgets(line, sizeof line, f)) return false;  // "FRAME...\n"
        if (strncmp(line, "FRAME", 5) != 0) return false;
        buf.resize(luma_bytes);
        if (fread(buf.data(), 1, luma_bytes, f) != luma_bytes) return false;
        if (chroma_bytes && fseek(f, long(chroma_bytes), SEEK_CUR) != 0) return false;
        return true;
    }

    void run() {
        for (;;) {
            std::vector<uint8_t> frame;
            bool ok = read_frame_into(frame);
            std::unique_lock<std::mutex> lk(mu);
            if (!ok) {
                eof = true;
                cv_cons.notify_all();
                return;
            }
            cv_prod.wait(lk, [&] { return stop || count < kRing; });
            if (stop) return;
            ring[head].swap(frame);
            head = (head + 1) % kRing;
            ++count;
            cv_cons.notify_one();
        }
    }

    int next(uint8_t* out) {
        std::unique_lock<std::mutex> lk(mu);
        cv_cons.wait(lk, [&] { return stop || count > 0 || eof; });
        if (stop || (count == 0 && eof)) return 0;
        memcpy(out, ring[tail].data(), luma_bytes);
        tail = (tail + 1) % kRing;
        --count;
        cv_prod.notify_one();
        return 1;
    }
};

}  // namespace

extern "C" {

void* vio_open(const char* path, int* w, int* h, long* fps_num, long* fps_den) {
    auto* r = new Y4MReader();
    r->f = fopen(path, "rb");
    if (!r->f || !r->parse_header()) {
        delete r;
        return nullptr;
    }
    r->ring.assign(kRing, {});
    *w = r->w;
    *h = r->h;
    *fps_num = r->fps_num;
    *fps_den = r->fps_den;
    r->worker = std::thread([r] { r->run(); });
    return r;
}

int vio_next(void* handle, uint8_t* out) {
    return static_cast<Y4MReader*>(handle)->next(out);
}

void vio_close(void* handle) {
    delete static_cast<Y4MReader*>(handle);
}

}  // extern "C"
