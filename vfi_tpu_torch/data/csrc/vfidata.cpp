// vfidata — native clip-loading runtime for vfi_tpu_torch (a copy of
// vfi_tpu's native/vfidata.cpp, built by vfi_tpu_torch/data/native_loader.py).
//
// Host-side replacement for the reference's Python DataLoader worker pool
// (train.py:40-41, src/data/base_dataset.py): decodes PNG/JPEG frames,
// resizes (bilinear), applies the reference's augmentation pipeline
// (RGB->BGR, horizontal flip, bottom/right pad, time reversal, [-1,1]
// normalize, optional BGR-luma grayscale) and assembles NHWC float32
// batches — all outside the Python GIL on a std::thread pool.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;  // HWC, RGB (or single channel)
};

bool decode_png(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  png_infop info = png ? png_create_info_struct(png) : nullptr;
  if (!info || setjmp(png_jmpbuf(png))) {
    if (png) png_destroy_read_struct(&png, &info, nullptr);
    fclose(fp);
    return false;
  }
  png_init_io(png, fp);
  png_read_info(png, info);
  png_uint_32 w = png_get_image_width(png, info), h = png_get_image_height(png, info);
  int bit_depth = png_get_bit_depth(png, info), color = png_get_color_type(png, info);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && bit_depth < 8) png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);
  int channels = png_get_channels(png, info);
  out->h = (int)h;
  out->w = (int)w;
  out->c = channels;
  out->data.resize((size_t)h * w * channels);
  std::vector<png_bytep> rows(h);
  for (png_uint_32 y = 0; y < h; ++y) rows[y] = out->data.data() + (size_t)y * w * channels;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  fclose(fp);
  return true;
}

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jb, 1);
}

bool decode_jpeg(const char* path, Image* out) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(fp);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, fp);
  jpeg_read_header(&cinfo, TRUE);
  jpeg_start_decompress(&cinfo);
  out->h = cinfo.output_height;
  out->w = cinfo.output_width;
  out->c = cinfo.output_components;
  out->data.resize((size_t)out->h * out->w * out->c);
  while ((int)cinfo.output_scanline < out->h) {
    JSAMPROW row = out->data.data() + (size_t)cinfo.output_scanline * out->w * out->c;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(fp);
  return true;
}

bool decode(const char* path, Image* out) {
  const char* dot = strrchr(path, '.');
  std::string ext = dot ? dot : "";
  for (auto& ch : ext) ch = (char)tolower(ch);
  if (ext == ".png" || ext == ".bmp") return decode_png(path, out);  // bmp unsupported -> fails
  if (ext == ".jpg" || ext == ".jpeg") return decode_jpeg(path, out);
  // Try both.
  return decode_png(path, out) || decode_jpeg(path, out);
}

// Bilinear resize matching cv2.resize's half-pixel sampling convention.
void resize_bilinear(const Image& src, int H, int W, Image* dst) {
  dst->h = H;
  dst->w = W;
  dst->c = src.c;
  dst->data.resize((size_t)H * W * src.c);
  const double sy = (double)src.h / H, sx = (double)src.w / W;
  for (int y = 0; y < H; ++y) {
    double fy = (y + 0.5) * sy - 0.5;
    int y0 = (int)floor(fy);
    double wy = fy - y0;
    int y0c = y0 < 0 ? 0 : (y0 >= src.h ? src.h - 1 : y0);
    int y1c = y0 + 1 < 0 ? 0 : (y0 + 1 >= src.h ? src.h - 1 : y0 + 1);
    for (int x = 0; x < W; ++x) {
      double fx = (x + 0.5) * sx - 0.5;
      int x0 = (int)floor(fx);
      double wx = fx - x0;
      int x0c = x0 < 0 ? 0 : (x0 >= src.w ? src.w - 1 : x0);
      int x1c = x0 + 1 < 0 ? 0 : (x0 + 1 >= src.w ? src.w - 1 : x0 + 1);
      for (int ch = 0; ch < src.c; ++ch) {
        double v00 = src.data[((size_t)y0c * src.w + x0c) * src.c + ch];
        double v01 = src.data[((size_t)y0c * src.w + x1c) * src.c + ch];
        double v10 = src.data[((size_t)y1c * src.w + x0c) * src.c + ch];
        double v11 = src.data[((size_t)y1c * src.w + x1c) * src.c + ch];
        double v = v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx + v10 * wy * (1 - wx) + v11 * wy * wx;
        dst->data[((size_t)y * W + x) * src.c + ch] = (uint8_t)(v + 0.5);
      }
    }
  }
}

// Process one decoded frame into its slot of the output batch.
// Output layout: [Hp, Wp, c_dim] float32 at `out`, Hp = H+pad_b, Wp = W+pad_r.
void process_frame(const Image& raw, int H, int W, int c_dim, int pad_b, int pad_r, bool flip,
                   float* out) {
  Image rgb3;
  const Image* img = &raw;
  Image tmp;
  if (raw.c == 1) {  // expand gray to 3 channels first (dataset semantics)
    tmp.h = raw.h;
    tmp.w = raw.w;
    tmp.c = 3;
    tmp.data.resize((size_t)raw.h * raw.w * 3);
    for (size_t i = 0; i < (size_t)raw.h * raw.w; ++i)
      tmp.data[3 * i] = tmp.data[3 * i + 1] = tmp.data[3 * i + 2] = raw.data[i];
    img = &tmp;
  }
  if (img->h != H || img->w != W) {
    resize_bilinear(*img, H, W, &rgb3);
    img = &rgb3;
  }
  const int Hp = H + pad_b, Wp = W + pad_r;
  // BGR luma weights (reference src/util/util.py:30-41 after RGB->BGR flip).
  const float wB = 0.1140f, wG = 0.5870f, wR = 0.2989f;
  for (int y = 0; y < Hp; ++y) {
    for (int x = 0; x < Wp; ++x) {
      float* dst = out + ((size_t)y * Wp + x) * c_dim;
      if (y >= H || x >= W) {  // zero padding -> normalized -1
        for (int ch = 0; ch < c_dim; ++ch) dst[ch] = -1.0f;
        continue;
      }
      int sx = flip ? (W - 1 - x) : x;
      const uint8_t* px = img->data.data() + ((size_t)y * W + sx) * 3;  // RGB
      float r = px[0] / 255.0f, g = px[1] / 255.0f, b = px[2] / 255.0f;
      if (c_dim == 1) {
        float gray = wB * b + wG * g + wR * r;
        dst[0] = gray * 2.0f - 1.0f;
      } else {
        // BGR channel order, [-1, 1]
        dst[0] = b * 2.0f - 1.0f;
        dst[1] = g * 2.0f - 1.0f;
        dst[2] = r * 2.0f - 1.0f;
      }
    }
  }
}

}  // namespace

extern "C" {

// Load B clips of T frames each into one NHWC float32 batch.
//  paths:        B*T frame file paths, clip-major
//  flip_flags:   per-clip horizontal flip (0/1)
//  rev_flags:    per-clip time reversal (0/1)
//  out:          [B, T, H+pad_b, W+pad_r, c_dim] float32
// Returns 0 on success, else the number of frames that failed to decode.
int vfid_load_clip_batch(const char** paths, int B, int T, int H, int W, int c_dim, int pad_b,
                         int pad_r, const uint8_t* flip_flags, const uint8_t* rev_flags,
                         float* out, int n_threads) {
  const size_t frame_elems = (size_t)(H + pad_b) * (W + pad_r) * c_dim;
  std::atomic<int> failures{0};
  std::atomic<int> next{0};
  const int total = B * T;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= total) return;
      int b = i / T, t = i % T;
      int t_out = rev_flags && rev_flags[b] ? (T - 1 - t) : t;
      Image img;
      if (!decode(paths[i], &img)) {
        failures.fetch_add(1);
        continue;
      }
      float* dst = out + ((size_t)b * T + t_out) * frame_elems;
      process_frame(img, H, W, c_dim, pad_b, pad_r, flip_flags && flip_flags[b], dst);
    }
  };
  int nt = n_threads > 0 ? n_threads : (int)std::thread::hardware_concurrency();
  if (nt < 1) nt = 1;
  if (nt > total) nt = total;
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i) threads.emplace_back(worker);
  worker();
  for (auto& th : threads) th.join();
  return failures.load();
}

int vfid_version() { return 1; }

}  // extern "C"
