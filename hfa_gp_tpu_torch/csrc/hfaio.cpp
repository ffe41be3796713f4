// hfaio — the native image loader of hfa_gp_tpu_torch (a copy of the JAX
// package's native/hfaio.cpp, which this file leaves as it is).
//
// The host side of the reference's loader stack (pinned-memory DataLoader
// workers, train_rgb.py:85-92, and arcface's DataLoaderX background-prefetch
// thread, arcface_torch/dataset.py:50-130): libpng/libjpeg decode +
// bilinear resize + [-1,1] normalize on CPU worker threads, with a bounded
// ring of ready batches. It runs on the host only; no CUDA here.
//
// One change from the JAX package's copy: a worker whose decode fails
// records the image's index in its batch (Batch::failed), and hfaio_next
// hands it to the caller, which raises with the path. The JAX copy leaves
// that image's slot as zeros and says nothing.
//
// C ABI (consumed by hfa_gp_tpu_torch/data/native_loader.py via ctypes):
//   hfaio_decode(path, out_size, out)            one image → float32 HWC;
//                                                -1 if it does not decode
//   hfaio_create(paths, n, out_size, batch,
//                workers, shuffle, seed, drop_last)
//   hfaio_next(handle, out, idx_out, failed_out) blocking; returns count;
//                                                *failed_out: the index of
//                                                an image that did not
//                                                decode, or -1
//   hfaio_destroy(handle)
//
// Build: g++ -O3 -shared -fPIC hfaio.cpp -o libhfaio.so -lpng -ljpeg -lpthread

#include <png.h>
#include <jpeglib.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<unsigned char> rgb;  // HWC, 3 channels
};

bool decode_png(FILE* f, Image* out) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr,
                             nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  png_set_expand(png);            // palette/gray/low-bit → 8-bit RGB
  png_set_strip_16(png);
  png_set_strip_alpha(png);
  png_set_gray_to_rgb(png);
  png_read_update_info(png, info);
  out->w = png_get_image_width(png, info);
  out->h = png_get_image_height(png, info);
  out->rgb.resize(size_t(out->w) * out->h * 3);
  std::vector<png_bytep> rows(out->h);
  for (int y = 0; y < out->h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * out->w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return true;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

bool decode_jpeg(FILE* f, Image* out) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    unsigned char* row =
        out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

bool decode_image(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  unsigned char magic[4] = {0};
  if (fread(magic, 1, 4, f) != 4) {
    fclose(f);
    return false;
  }
  rewind(f);
  bool ok = false;
  if (magic[0] == 0x89 && magic[1] == 'P')
    ok = decode_png(f, out);
  else if (magic[0] == 0xFF && magic[1] == 0xD8)
    ok = decode_jpeg(f, out);
  fclose(f);
  return ok;
}

// bilinear resize + normalize to [-1, 1]
void resize_normalize(const Image& img, int out_size, float* out) {
  const float sx = float(img.w) / out_size;
  const float sy = float(img.h) / out_size;
  for (int oy = 0; oy < out_size; ++oy) {
    float fy = (oy + 0.5f) * sy - 0.5f;
    int y0 = (int)floorf(fy);
    float wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= img.h ? img.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= img.h ? img.h - 1 : y0 + 1);
    for (int ox = 0; ox < out_size; ++ox) {
      float fx = (ox + 0.5f) * sx - 0.5f;
      int x0 = (int)floorf(fx);
      float wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= img.w ? img.w - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= img.w ? img.w - 1 : x0 + 1);
      const unsigned char* p00 =
          img.rgb.data() + (size_t(y0c) * img.w + x0c) * 3;
      const unsigned char* p01 =
          img.rgb.data() + (size_t(y0c) * img.w + x1c) * 3;
      const unsigned char* p10 =
          img.rgb.data() + (size_t(y1c) * img.w + x0c) * 3;
      const unsigned char* p11 =
          img.rgb.data() + (size_t(y1c) * img.w + x1c) * 3;
      float* dst = out + (size_t(oy) * out_size + ox) * 3;
      for (int c = 0; c < 3; ++c) {
        float v = p00[c] * (1 - wx) * (1 - wy) + p01[c] * wx * (1 - wy) +
                  p10[c] * (1 - wx) * wy + p11[c] * wx * wy;
        dst[c] = v * (2.0f / 255.0f) - 1.0f;
      }
    }
  }
}

struct Batch {
  std::vector<float> data;
  std::vector<int> indices;
  int count = 0;
  int failed = -1;  // index of the first image that did not decode
};

struct Loader {
  std::vector<std::string> paths;
  int out_size, batch, workers;
  bool shuffle, drop_last;
  std::mt19937 rng;

  std::vector<std::thread> threads;
  std::mutex mu;
  std::condition_variable cv_ready, cv_space;
  std::deque<Batch> ready;
  size_t max_queue;

  // epoch state
  std::vector<int> order;
  size_t cursor = 0;
  std::mutex order_mu;
  std::atomic<bool> stop{false};

  void reshuffle_locked() {
    if (order.empty()) {
      order.resize(paths.size());
      for (size_t i = 0; i < paths.size(); ++i) order[i] = (int)i;
    }
    if (shuffle) std::shuffle(order.begin(), order.end(), rng);
    cursor = 0;
  }

  bool next_indices(std::vector<int>* idx) {
    std::lock_guard<std::mutex> lk(order_mu);
    idx->clear();
    for (int i = 0; i < batch; ++i) {
      if (cursor >= order.size()) {
        if (!drop_last && !idx->empty()) break;  // emit the partial batch
        reshuffle_locked();  // drop_last: wrap into the next epoch
      }
      idx->push_back(order[cursor++]);
    }
    return !idx->empty();
  }

  void worker() {
    const size_t frame = size_t(out_size) * out_size * 3;
    while (!stop.load()) {
      std::vector<int> idx;
      if (!next_indices(&idx)) continue;
      Batch b;
      b.data.resize(frame * batch, 0.0f);
      b.indices = idx;
      b.count = (int)idx.size();
      for (size_t i = 0; i < idx.size(); ++i) {
        Image img;
        if (decode_image(paths[idx[i]].c_str(), &img))
          resize_normalize(img, out_size, b.data.data() + i * frame);
        else if (b.failed < 0)
          b.failed = idx[i];
      }
      std::unique_lock<std::mutex> lk(mu);
      cv_space.wait(lk, [&] {
        return ready.size() < max_queue || stop.load();
      });
      if (stop.load()) return;
      ready.push_back(std::move(b));
      cv_ready.notify_one();
    }
  }
};

}  // namespace

extern "C" {

int hfaio_decode(const char* path, int out_size, float* out) {
  Image img;
  if (!decode_image(path, &img)) return -1;
  resize_normalize(img, out_size, out);
  return 0;
}

void* hfaio_create(const char** paths, int n, int out_size, int batch,
                   int workers, int shuffle, unsigned seed,
                   int drop_last) {
  Loader* l = new Loader();
  l->paths.assign(paths, paths + n);
  l->out_size = out_size;
  l->batch = batch;
  l->workers = workers > 0 ? workers : 2;
  l->shuffle = shuffle != 0;
  l->drop_last = drop_last != 0;
  l->rng.seed(seed);
  l->max_queue = size_t(l->workers) * 2;
  {
    std::lock_guard<std::mutex> lk(l->order_mu);
    l->reshuffle_locked();
  }
  for (int i = 0; i < l->workers; ++i)
    l->threads.emplace_back(&Loader::worker, l);
  return l;
}

int hfaio_next(void* handle, float* out, int* idx_out, int* failed_out) {
  Loader* l = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(l->mu);
  l->cv_ready.wait(lk, [&] { return !l->ready.empty() || l->stop.load(); });
  if (l->stop.load()) return -1;
  Batch b = std::move(l->ready.front());
  l->ready.pop_front();
  l->cv_space.notify_one();
  lk.unlock();
  std::memcpy(out, b.data.data(), b.data.size() * sizeof(float));
  if (idx_out)
    std::memcpy(idx_out, b.indices.data(),
                b.indices.size() * sizeof(int));
  if (failed_out) *failed_out = b.failed;
  return b.count;
}

void hfaio_destroy(void* handle) {
  Loader* l = static_cast<Loader*>(handle);
  l->stop.store(true);
  l->cv_ready.notify_all();
  l->cv_space.notify_all();
  for (auto& t : l->threads) t.join();
  delete l;
}

}  // extern "C"
