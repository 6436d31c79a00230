// Native software rasterizer + async frame pipeline for aprilslam_tpu.
//
// This is the framework's native runtime tier: the C++ counterpart of the
// reference's OpenGL renderer + SDL loop (reference renderer.py:197-274),
// used for host-side frame generation and IO when the on-device JAX
// rasterizer is not the right tool (CPU-only hosts, file ingest, feeding
// the device asynchronously). Conventions match sim/rasterizer.py exactly:
// GL world frame, camera rotation Ry(yaw)Rx(pitch)Rz(roll)
// (camera_controller.py:163-194), tag rotation Rz Ry Rx
// (renderer.py:232-237), GL->CV flip diag(1,-1,-1) (ground_truth.py:71-83),
// pixel centres at +0.5, z-buffered, optional supersampling.
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).

#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

namespace {

struct Mat3 {
  double m[9];
  static Mat3 identity() { return {{1, 0, 0, 0, 1, 0, 0, 0, 1}}; }
  Mat3 operator*(const Mat3 &o) const {
    Mat3 r{};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        double s = 0;
        for (int k = 0; k < 3; ++k) s += m[i * 3 + k] * o.m[k * 3 + j];
        r.m[i * 3 + j] = s;
      }
    return r;
  }
  void mul_vec(const double v[3], double out[3]) const {
    for (int i = 0; i < 3; ++i)
      out[i] = m[i * 3] * v[0] + m[i * 3 + 1] * v[1] + m[i * 3 + 2] * v[2];
  }
  Mat3 transposed() const {
    Mat3 r{};
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) r.m[i * 3 + j] = m[j * 3 + i];
    return r;
  }
  bool invert(Mat3 &out) const {
    const double *a = m;
    double det = a[0] * (a[4] * a[8] - a[5] * a[7]) -
                 a[1] * (a[3] * a[8] - a[5] * a[6]) +
                 a[2] * (a[3] * a[7] - a[4] * a[6]);
    if (std::fabs(det) < 1e-14) return false;
    double inv = 1.0 / det;
    out.m[0] = (a[4] * a[8] - a[5] * a[7]) * inv;
    out.m[1] = (a[2] * a[7] - a[1] * a[8]) * inv;
    out.m[2] = (a[1] * a[5] - a[2] * a[4]) * inv;
    out.m[3] = (a[5] * a[6] - a[3] * a[8]) * inv;
    out.m[4] = (a[0] * a[8] - a[2] * a[6]) * inv;
    out.m[5] = (a[2] * a[3] - a[0] * a[5]) * inv;
    out.m[6] = (a[3] * a[7] - a[4] * a[6]) * inv;
    out.m[7] = (a[1] * a[6] - a[0] * a[7]) * inv;
    out.m[8] = (a[0] * a[4] - a[1] * a[3]) * inv;
    return true;
  }
};

Mat3 rot_x(double deg) {
  double r = deg * M_PI / 180.0, c = std::cos(r), s = std::sin(r);
  return {{1, 0, 0, 0, c, -s, 0, s, c}};
}
Mat3 rot_y(double deg) {
  double r = deg * M_PI / 180.0, c = std::cos(r), s = std::sin(r);
  return {{c, 0, s, 0, 1, 0, -s, 0, c}};
}
Mat3 rot_z(double deg) {
  double r = deg * M_PI / 180.0, c = std::cos(r), s = std::sin(r);
  return {{c, -s, 0, s, c, 0, 0, 0, 1}};
}

struct TagXform {
  Mat3 G;        // pixel -> tag plane homography (inverse)
  double rz0, rz1, tz;  // CV z-row of [r0 r1 t] for depth
  const float *tex;
  int cells;
  bool valid;
};

struct SceneDesc {
  const float *textures;  // (T, C, C)
  const float *tag_pos;   // (T, 3) GL world
  const float *tag_rot;   // (T, 3) deg
  int n_tags;
  int cells;
  double outer_half;
  double background;
  double near_clip, far_clip;
  double fx, fy, cx, cy;
};

void compute_tag_xforms(const SceneDesc &sc, const float *cam_pos,
                        const float *cam_rot, std::vector<TagXform> &out) {
  // camera world rotation Ry(yaw) Rx(pitch) Rz(roll); input [pitch, yaw, roll]
  Mat3 Rcam = rot_y(cam_rot[1]) * rot_x(cam_rot[0]) * rot_z(cam_rot[2]);
  Mat3 RcamT = Rcam.transposed();
  const Mat3 flip = {{1, 0, 0, 0, -1, 0, 0, 0, -1}};
  Mat3 Kinv = {{1.0 / sc.fx, 0, -sc.cx / sc.fx, 0, 1.0 / sc.fy, -sc.cy / sc.fy, 0, 0, 1}};

  out.resize(sc.n_tags);
  for (int t = 0; t < sc.n_tags; ++t) {
    // tag rotation Rz Ry Rx of [rx, ry, rz]
    const float *tr = sc.tag_rot + 3 * t;
    Mat3 Rtag = rot_z(tr[2]) * rot_y(tr[1]) * rot_x(tr[0]);
    double rel[3] = {sc.tag_pos[3 * t] - cam_pos[0], sc.tag_pos[3 * t + 1] - cam_pos[1],
                     sc.tag_pos[3 * t + 2] - cam_pos[2]};
    double rel_eye[3];
    RcamT.mul_vec(rel, rel_eye);
    Mat3 R_eye = RcamT * Rtag;
    // CV frame
    double rel_cv[3];
    flip.mul_vec(rel_eye, rel_cv);
    Mat3 R_cv = flip * R_eye;
    // H = [r0 | r1 | t_cv]
    Mat3 H = {{R_cv.m[0], R_cv.m[1], rel_cv[0], R_cv.m[3], R_cv.m[4], rel_cv[1],
               R_cv.m[6], R_cv.m[7], rel_cv[2]}};
    Mat3 Hinv;
    TagXform &x = out[t];
    x.valid = H.invert(Hinv);
    if (!x.valid) continue;
    x.G = Hinv * Kinv;
    x.rz0 = R_cv.m[6];
    x.rz1 = R_cv.m[7];
    x.tz = rel_cv[2];
    x.tex = sc.textures + (size_t)t * sc.cells * sc.cells;
    x.cells = sc.cells;
  }
}

void render_one_frame(const SceneDesc &sc, const float *cam_pos, const float *cam_rot,
                      float *out, int height, int width, int supersample) {
  std::vector<TagXform> xf;
  compute_tag_xforms(sc, cam_pos, cam_rot, xf);
  const double h = sc.outer_half;
  const int C = sc.cells;
  const int ss = supersample < 1 ? 1 : supersample;
  const double inv_ss2 = 1.0 / (ss * ss);

  for (int row = 0; row < height; ++row) {
    for (int col = 0; col < width; ++col) {
      double acc = 0.0;
      for (int sy = 0; sy < ss; ++sy) {
        for (int sx = 0; sx < ss; ++sx) {
          double u = col + (sx + 0.5) / ss;
          double v = row + (sy + 0.5) / ss;
          double best = sc.background;
          double best_depth = 1e30;
          for (int t = 0; t < sc.n_tags; ++t) {
            const TagXform &x = xf[t];
            if (!x.valid) continue;
            const double *G = x.G.m;
            double q0 = G[0] * u + G[1] * v + G[2];
            double q1 = G[3] * u + G[4] * v + G[5];
            double q2 = G[6] * u + G[7] * v + G[8];
            if (std::fabs(q2) < 1e-12) continue;
            double a = q0 / q2, b = q1 / q2;
            if (std::fabs(a) > h || std::fabs(b) > h) continue;
            double depth = a * x.rz0 + b * x.rz1 + x.tz;
            if (depth <= sc.near_clip || depth >= sc.far_clip) continue;
            if (depth >= best_depth) continue;
            int cc = (int)std::floor((a + h) / (2 * h) * C);
            int rr = (int)std::floor((h - b) / (2 * h) * C);
            if (cc < 0) cc = 0;
            if (cc >= C) cc = C - 1;
            if (rr < 0) rr = 0;
            if (rr >= C) rr = C - 1;
            best = x.tex[rr * C + cc];
            best_depth = depth;
          }
          acc += best;
        }
      }
      out[(size_t)row * width + col] = (float)(acc * inv_ss2);
    }
  }
}

// ---------------------------------------------------------------- pipeline

struct FramePipeline {
  SceneDesc scene;
  std::vector<float> textures_copy, pos_copy, rot_copy;
  std::vector<float> traj_pos, traj_rot;  // (N, 3) each
  int n_frames = 0, height = 0, width = 0, batch = 0, supersample = 1;
  int n_threads = 1;

  std::vector<std::vector<float>> slots;  // ring of batch buffers
  std::queue<int> ready;                  // filled slot indices
  std::queue<int> freeq;                  // available slot indices
  std::vector<int> slot_first_frame;
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<bool> stop_flag{false};
  std::vector<std::thread> workers;
  std::atomic<int> next_batch{0};
  int n_batches = 0;
  int delivered = 0;  // guarded by mu
};

void pipeline_worker(FramePipeline *p) {
  for (;;) {
    if (p->stop_flag.load()) return;
    int bi = p->next_batch.fetch_add(1);
    if (bi >= p->n_batches) return;
    int slot;
    {
      std::unique_lock<std::mutex> lk(p->mu);
      p->cv_free.wait(lk, [&] { return !p->freeq.empty() || p->stop_flag.load(); });
      if (p->stop_flag.load()) return;
      slot = p->freeq.front();
      p->freeq.pop();
    }
    float *buf = p->slots[slot].data();
    const size_t frame_px = (size_t)p->height * p->width;
    for (int f = 0; f < p->batch; ++f) {
      int fi = bi * p->batch + f;
      render_one_frame(p->scene, &p->traj_pos[3 * fi], &p->traj_rot[3 * fi],
                       buf + f * frame_px, p->height, p->width, p->supersample);
    }
    {
      std::lock_guard<std::mutex> lk(p->mu);
      p->slot_first_frame[slot] = bi * p->batch;
      p->ready.push(slot);
    }
    p->cv_ready.notify_one();
  }
}

}  // namespace

extern "C" {

// One-shot batch render (synchronous, multithreaded over frames).
void asr_render_frames(const float *textures, int n_tags, int cells,
                       const float *tag_pos, const float *tag_rot,
                       double outer_half, double background, double near_clip,
                       double far_clip, double fx, double fy, double cx, double cy,
                       const float *cam_pos, const float *cam_rot, int n_frames,
                       int height, int width, int supersample, int n_threads,
                       float *out) {
  SceneDesc sc{textures, tag_pos, tag_rot, n_tags, cells, outer_half,
               background, near_clip, far_clip, fx, fy, cx, cy};
  const size_t frame_px = (size_t)height * width;
  if (n_threads <= 1 || n_frames == 1) {
    for (int f = 0; f < n_frames; ++f)
      render_one_frame(sc, cam_pos + 3 * f, cam_rot + 3 * f, out + f * frame_px,
                       height, width, supersample);
    return;
  }
  std::atomic<int> next{0};
  auto work = [&] {
    for (;;) {
      int f = next.fetch_add(1);
      if (f >= n_frames) return;
      render_one_frame(sc, cam_pos + 3 * f, cam_rot + 3 * f, out + f * frame_px,
                       height, width, supersample);
    }
  };
  std::vector<std::thread> ts;
  int nt = n_threads < n_frames ? n_threads : n_frames;
  for (int i = 0; i < nt; ++i) ts.emplace_back(work);
  for (auto &t : ts) t.join();
}

// Async double(+)-buffered pipeline: background threads keep rendering frame
// batches into a slot ring; the consumer pulls finished batches.
void *asr_pipeline_create(const float *textures, int n_tags, int cells,
                          const float *tag_pos, const float *tag_rot,
                          double outer_half, double background, double near_clip,
                          double far_clip, double fx, double fy, double cx,
                          double cy, const float *traj_pos, const float *traj_rot,
                          int n_frames, int height, int width, int batch,
                          int supersample, int n_slots, int n_threads) {
  auto *p = new FramePipeline();
  size_t tex_n = (size_t)n_tags * cells * cells;
  p->textures_copy.assign(textures, textures + tex_n);
  p->pos_copy.assign(tag_pos, tag_pos + 3 * n_tags);
  p->rot_copy.assign(tag_rot, tag_rot + 3 * n_tags);
  p->scene = SceneDesc{p->textures_copy.data(), p->pos_copy.data(), p->rot_copy.data(),
                       n_tags, cells, outer_half, background, near_clip, far_clip,
                       fx, fy, cx, cy};
  p->traj_pos.assign(traj_pos, traj_pos + 3 * n_frames);
  p->traj_rot.assign(traj_rot, traj_rot + 3 * n_frames);
  p->n_frames = n_frames;
  p->height = height;
  p->width = width;
  p->batch = batch;
  p->supersample = supersample;
  p->n_batches = n_frames / batch;
  p->n_threads = n_threads;
  if (n_slots < 2) n_slots = 2;
  p->slots.resize(n_slots);
  p->slot_first_frame.resize(n_slots, -1);
  for (auto &s : p->slots) s.resize((size_t)batch * height * width);
  for (int i = 0; i < n_slots; ++i) p->freeq.push(i);
  for (int i = 0; i < n_threads; ++i) p->workers.emplace_back(pipeline_worker, p);
  return p;
}

// Blocks until a batch is ready; copies it into `out` and returns the first
// frame index, or -1 when the stream is exhausted.
int asr_pipeline_next(void *handle, float *out) {
  auto *p = static_cast<FramePipeline *>(handle);
  int slot;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    if (p->delivered >= p->n_batches) return -1;  // stream exhausted
    p->cv_ready.wait(lk, [&] { return !p->ready.empty() || p->stop_flag.load(); });
    if (p->ready.empty()) return -1;
    slot = p->ready.front();
    p->ready.pop();
    p->delivered += 1;
  }
  size_t n = (size_t)p->batch * p->height * p->width;
  std::memcpy(out, p->slots[slot].data(), n * sizeof(float));
  int first = p->slot_first_frame[slot];
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->freeq.push(slot);
  }
  p->cv_free.notify_one();
  return first;
}

void asr_pipeline_destroy(void *handle) {
  auto *p = static_cast<FramePipeline *>(handle);
  p->stop_flag.store(true);
  p->cv_free.notify_all();
  p->cv_ready.notify_all();
  for (auto &w : p->workers)
    if (w.joinable()) w.join();
  delete p;
}

int asr_version() { return 1; }

}  // extern "C"
