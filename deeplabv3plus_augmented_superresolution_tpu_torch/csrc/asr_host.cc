// Native host-staging runtime for the port's ASR serving path: a copy of
// the JAX package's native/asr_host.cc (the port imports nothing of that
// package), built into build/torch_host/ by data/native_loader.py.
//
// It keeps the card fed by moving the host-side image work off the Python
// thread: JPEG/PNG decode (libjpeg / libpng), TF-semantics resize
// (half-pixel centers, no antialias: the algorithm of ops/resize.py), and a
// bounded in-order staging ring decoded by a worker pool. Python consumes
// ready frames via ctypes and copies them to the card while workers decode
// ahead.
//
// C ABI:
//   asr_load_image(path, out_h, out_w, is_label, normalize, out)  one-shot
//   asr_ring_create(paths, n, out_h, out_w, is_label, normalize,
//                   n_threads, capacity)                           -> handle
//   asr_ring_create2(..., bf16)   frames as bf16 (uint16 bit patterns)
//   asr_ring_next(handle, out, &index)   blocking, in path order; 1 ok / 0
//                                        end of stream / -1 decode error
//   asr_ring_destroy(handle)

#include <cstdio>  // must precede jpeglib.h (it needs FILE declared)

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <condition_variable>
#include <csetjmp>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<unsigned char> data;  // h * w * c
};

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jump, 1);
}

bool decode_jpeg_rgb(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  jpeg_decompress_struct cinfo;
  JpegErr err;
  cinfo.err = jpeg_std_error(&err.mgr);
  err.mgr.error_exit = jpeg_err_exit;
  if (setjmp(err.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = 3;
  out->data.resize(size_t(out->h) * out->w * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out->data.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return true;
}

// Label PNGs: palette images yield the palette INDEX (the VOC class id),
// grayscale yields the gray value — matching PIL's mode-P/L reads used by
// data/io.py load_image(is_png=True).
bool decode_png_labels(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                           nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, info ? &info : nullptr, nullptr);
    fclose(f);
    return false;
  }
  png_init_io(png, f);
  png_read_info(png, info);
  const int color = png_get_color_type(png, info);
  const int depth = png_get_bit_depth(png, info);
  if (depth == 16) png_set_strip_16(png);
  if (depth < 8) png_set_packing(png);  // 1 byte per pixel, value preserved
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  if (color == PNG_COLOR_TYPE_RGB || color == PNG_COLOR_TYPE_RGB_ALPHA)
    png_set_rgb_to_gray_fixed(png, 1, -1, -1);
  png_read_update_info(png, info);
  out->h = png_get_image_height(png, info);
  out->w = png_get_image_width(png, info);
  out->c = 1;
  const size_t rowbytes = png_get_rowbytes(png, info);
  std::vector<unsigned char> rowbuf(rowbytes);
  out->data.resize(size_t(out->h) * out->w);
  for (int y = 0; y < out->h; ++y) {
    png_read_row(png, rowbuf.data(), nullptr);
    std::memcpy(out->data.data() + size_t(y) * out->w, rowbuf.data(), out->w);
  }
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// TF-semantics resize (ops/resize.py algorithm)
// ---------------------------------------------------------------------------

struct Lerp {
  std::vector<int> lo, hi;
  std::vector<float> frac;
};

Lerp lerp_coords(int out_size, int in_size) {
  Lerp l;
  l.lo.resize(out_size);
  l.hi.resize(out_size);
  l.frac.resize(out_size);
  const double scale = double(in_size) / out_size;
  for (int d = 0; d < out_size; ++d) {
    double src = (d + 0.5) * scale - 0.5;
    if (src < 0) src = 0;
    int lo = int(src);
    if (lo > in_size - 1) lo = in_size - 1;
    int hi = lo + 1 < in_size ? lo + 1 : in_size - 1;
    l.lo[d] = lo;
    l.hi[d] = hi;
    l.frac[d] = float(src - lo);
  }
  return l;
}

std::vector<int> nearest_coords(int out_size, int in_size) {
  std::vector<int> idx(out_size);
  const double scale = double(in_size) / out_size;
  for (int d = 0; d < out_size; ++d) {
    int s = int((d + 0.5) * scale);
    idx[d] = s < in_size - 1 ? s : in_size - 1;
  }
  return idx;
}

// uint8 HWC -> float32 HWC, bilinear (images) or nearest (labels).
void resize_to(const Image& im, int out_h, int out_w, bool nearest,
               float norm_scale, float* out) {
  const int c = im.c;
  if (im.h == out_h && im.w == out_w) {
    const size_t n = size_t(out_h) * out_w * c;
    for (size_t i = 0; i < n; ++i) out[i] = im.data[i] * norm_scale;
    return;
  }
  if (nearest) {
    const auto ys = nearest_coords(out_h, im.h);
    const auto xs = nearest_coords(out_w, im.w);
    for (int y = 0; y < out_h; ++y) {
      const unsigned char* row = im.data.data() + size_t(ys[y]) * im.w * c;
      float* orow = out + size_t(y) * out_w * c;
      for (int x = 0; x < out_w; ++x)
        for (int k = 0; k < c; ++k)
          orow[x * c + k] = row[xs[x] * c + k] * norm_scale;
    }
    return;
  }
  const Lerp ly = lerp_coords(out_h, im.h);
  const Lerp lx = lerp_coords(out_w, im.w);
  // Horizontal pass into a (in_h, out_w, c) buffer, then vertical lerp.
  std::vector<float> mid(size_t(im.h) * out_w * c);
  for (int y = 0; y < im.h; ++y) {
    const unsigned char* row = im.data.data() + size_t(y) * im.w * c;
    float* orow = mid.data() + size_t(y) * out_w * c;
    for (int x = 0; x < out_w; ++x) {
      const float t = lx.frac[x];
      const unsigned char* a = row + lx.lo[x] * c;
      const unsigned char* b = row + lx.hi[x] * c;
      for (int k = 0; k < c; ++k)
        orow[x * c + k] = (1.0f - t) * a[k] + t * b[k];
    }
  }
  for (int y = 0; y < out_h; ++y) {
    const float t = ly.frac[y];
    const float* a = mid.data() + size_t(ly.lo[y]) * out_w * c;
    const float* b = mid.data() + size_t(ly.hi[y]) * out_w * c;
    float* orow = out + size_t(y) * out_w * c;
    for (int i = 0; i < out_w * c; ++i)
      orow[i] = ((1.0f - t) * a[i] + t * b[i]) * norm_scale;
  }
}

bool load_one(const std::string& path, int out_h, int out_w, bool is_label,
              bool normalize, float* out) {
  Image im;
  const bool png = is_label;
  if (png ? !decode_png_labels(path.c_str(), &im)
          : !decode_jpeg_rgb(path.c_str(), &im))
    return false;
  const float scale = normalize ? 1.0f / 255.0f : 1.0f;
  resize_to(im, out_h, out_w, /*nearest=*/is_label, scale, out);
  return true;
}

// f32 -> bf16 with round-to-nearest-even (torch's and XLA's conversion).
// Frames delivered as bf16 halve the host->device transfer and skip a
// host-side cast; the serving model consumes bf16 at entry anyway
// (pipeline/end_to_end.py), so nothing downstream changes.
inline unsigned short f32_to_bf16(float f) {
  unsigned int x;
  std::memcpy(&x, &f, 4);
  const unsigned int rounding = 0x7FFFu + ((x >> 16) & 1u);
  return static_cast<unsigned short>((x + rounding) >> 16);
}

// ---------------------------------------------------------------------------
// in-order staging ring
// ---------------------------------------------------------------------------

struct Ring {
  std::vector<std::string> paths;
  int out_h, out_w, channels;
  bool is_label, normalize, bf16 = false;
  size_t frame_elems;
  size_t frame_bytes;

  std::vector<std::vector<unsigned char>> slots;
  std::vector<int> slot_state;  // 0 free, 1 ready, -1 failed
  std::mutex mu;
  std::condition_variable cv_ready, cv_free;
  std::atomic<size_t> next_to_claim{0};
  size_t next_to_consume = 0;
  bool stopping = false;
  std::vector<std::thread> workers;

  ~Ring() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
    }
    cv_free.notify_all();
    for (auto& t : workers) t.join();
  }

  void worker() {
    std::vector<float> tmp(frame_elems);
    std::vector<unsigned char> frame(frame_bytes);
    for (;;) {
      const size_t idx = next_to_claim.fetch_add(1);
      if (idx >= paths.size()) return;
      const bool ok = load_one(paths[idx], out_h, out_w, is_label, normalize,
                               tmp.data());
      if (ok) {
        if (bf16) {
          auto* dst = reinterpret_cast<unsigned short*>(frame.data());
          for (size_t i = 0; i < frame_elems; ++i) dst[i] = f32_to_bf16(tmp[i]);
        } else {
          std::memcpy(frame.data(), tmp.data(), frame_bytes);
        }
      }
      const size_t slot = idx % slots.size();
      std::unique_lock<std::mutex> lock(mu);
      // In-order delivery: this slot may only be written once its previous
      // occupant (index idx - capacity) has been CONSUMED, i.e. when idx is
      // inside the consumer's window. slot_state == 0 alone cannot tell
      // "never filled" apart from "consumed": with more workers than
      // in-window indices, the worker for idx + capacity could otherwise
      // overwrite the still-pending slot of idx and deliver under the wrong
      // index. next_to_consume counts the consumed prefix (advanced only
      // after the copy-out), so the window test is exact.
      cv_free.wait(lock, [&] {
        return stopping ||
               (idx < next_to_consume + slots.size() && slot_state[slot] == 0);
      });
      if (stopping) return;
      if (ok) slots[slot].swap(frame);
      slot_state[slot] = ok ? 1 : -1;
      cv_ready.notify_all();
      if (ok) frame.resize(frame_bytes);
    }
  }

  int next(unsigned char* out, int* index) {
    std::unique_lock<std::mutex> lock(mu);
    if (next_to_consume >= paths.size()) return 0;
    const size_t idx = next_to_consume;  // advanced only after the copy-out
    const size_t slot = idx % slots.size();
    cv_ready.wait(lock, [&] { return slot_state[slot] != 0; });
    const int state = slot_state[slot];
    if (state == 1) std::memcpy(out, slots[slot].data(), frame_bytes);
    slot_state[slot] = 0;
    next_to_consume = idx + 1;
    *index = int(idx);
    cv_free.notify_all();
    return state == 1 ? 1 : -1;
  }
};

}  // namespace

extern "C" {

int asr_load_image(const char* path, int out_h, int out_w, int is_label,
                   int normalize, float* out) {
  return load_one(path, out_h, out_w, is_label != 0, normalize != 0, out) ? 1
                                                                          : -1;
}

static void* ring_create_impl(const char* const* paths, int n, int out_h,
                              int out_w, int is_label, int normalize,
                              int n_threads, int capacity, int bf16) {
  auto* r = new Ring();
  r->paths.assign(paths, paths + n);
  r->out_h = out_h;
  r->out_w = out_w;
  r->is_label = is_label != 0;
  r->normalize = normalize != 0;
  r->bf16 = bf16 != 0;
  r->channels = r->is_label ? 1 : 3;
  r->frame_elems = size_t(out_h) * out_w * r->channels;
  r->frame_bytes = r->frame_elems * (r->bf16 ? 2 : sizeof(float));
  if (capacity < 2) capacity = 2;
  if (n_threads < 1) n_threads = 1;
  r->slots.resize(capacity);
  for (auto& s : r->slots) s.resize(r->frame_bytes);
  r->slot_state.assign(capacity, 0);
  for (int i = 0; i < n_threads; ++i)
    r->workers.emplace_back(&Ring::worker, r);
  return r;
}

void* asr_ring_create(const char* const* paths, int n, int out_h, int out_w,
                      int is_label, int normalize, int n_threads,
                      int capacity) {
  return ring_create_impl(paths, n, out_h, out_w, is_label, normalize,
                          n_threads, capacity, /*bf16=*/0);
}

// v2: bf16 frame delivery (see f32_to_bf16). asr_ring_next is shared; the
// out buffer's element type follows the creation flag.
void* asr_ring_create2(const char* const* paths, int n, int out_h, int out_w,
                       int is_label, int normalize, int n_threads,
                       int capacity, int bf16) {
  return ring_create_impl(paths, n, out_h, out_w, is_label, normalize,
                          n_threads, capacity, bf16);
}

int asr_ring_next(void* ring, float* out, int* index) {
  return static_cast<Ring*>(ring)->next(
      reinterpret_cast<unsigned char*>(out), index);
}

void asr_ring_destroy(void* ring) { delete static_cast<Ring*>(ring); }

}  // extern "C"
