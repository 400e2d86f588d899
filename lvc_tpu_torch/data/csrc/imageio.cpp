// Native data-loading core: image decode + resize for the input pipeline.
//
// A copy of lvc_tpu/data/csrc/imageio.cpp (the port keeps its own), less its
// space-to-depth entry: the port has no s2d stem.
//
// Counterpart of the reference's C++-backed data path (torch DataLoader
// workers + PIL-on-libjpeg decode inside detectron2's
// data/detection_utils.read_image). Exposed as a C ABI for ctypes; every
// entry point is GIL-free so the Python-side thread pool gets real
// parallelism on decode + resize (the loader's hot loop).
//
// Resize implements PIL's convolution resampling (Resample.c): a triangle
// (bilinear) filter whose support scales with the downscale factor,
// separable two-pass, double accumulation — matches PIL.BILINEAR within
// +-1 LSB (PIL uses 8-bit fixed-point coefficients).
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <jpeglib.h>
#include <png.h>
#include <csetjmp>

namespace {

struct JpegErr {
    jpeg_error_mgr pub;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
    longjmp(err->jb, 1);
}

// RGB8 decode of a JPEG byte buffer; returns malloc'd H*W*3.
uint8_t* decode_jpeg(const uint8_t* data, size_t len, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    // declared before setjmp so the longjmp error path can free a
    // partially-filled buffer (libjpeg can error out mid-scanlines)
    uint8_t* volatile out = nullptr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        free(out);
        jpeg_destroy_decompress(&cinfo);
        return nullptr;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    *h = cinfo.output_height;
    *w = cinfo.output_width;
    out = static_cast<uint8_t*>(malloc(size_t(*h) * *w * 3));
    while (cinfo.output_scanline < cinfo.output_height) {
        uint8_t* row = out + size_t(cinfo.output_scanline) * *w * 3;
        jpeg_read_scanlines(&cinfo, &row, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return out;
}

// RGB8 decode of a PNG byte buffer via the libpng simplified API.
uint8_t* decode_png(const uint8_t* data, size_t len, int* h, int* w) {
    png_image image;
    memset(&image, 0, sizeof(image));
    image.version = PNG_IMAGE_VERSION;
    if (!png_image_begin_read_from_memory(&image, data, len)) return nullptr;
    image.format = PNG_FORMAT_RGB;
    *h = image.height;
    *w = image.width;
    uint8_t* out = static_cast<uint8_t*>(malloc(PNG_IMAGE_SIZE(image)));
    if (!png_image_finish_read(&image, nullptr, out, 0, nullptr)) {
        free(out);
        return nullptr;
    }
    return out;
}

uint8_t* decode_any(const uint8_t* data, size_t len, int* h, int* w) {
    if (len >= 2 && data[0] == 0xFF && data[1] == 0xD8) return decode_jpeg(data, len, h, w);
    if (len >= 4 && data[0] == 0x89 && data[1] == 'P') return decode_png(data, len, h, w);
    // try jpeg then png as a fallback
    uint8_t* out = decode_jpeg(data, len, h, w);
    return out ? out : decode_png(data, len, h, w);
}

// One separable pass of PIL-style triangle resampling along the row axis
// of an (h, w, c) u8 image -> (h, out_size, c) f32 (pass 1) or back to u8
// handled by caller.
struct Coeffs {
    std::vector<int> xmin, xlen;
    std::vector<double> weights;  // flattened, stride = max support width
    int kmax;
};

Coeffs precompute(int in_size, int out_size) {
    Coeffs c;
    double scale = double(in_size) / out_size;
    double filterscale = std::max(scale, 1.0);
    double support = 1.0 * filterscale;  // bilinear support = 1
    int kmax = int(ceil(support)) * 2 + 1;
    c.kmax = kmax;
    c.xmin.resize(out_size);
    c.xlen.resize(out_size);
    c.weights.assign(size_t(out_size) * kmax, 0.0);
    for (int xx = 0; xx < out_size; ++xx) {
        double center = (xx + 0.5) * scale;
        int xmin = std::max(0, int(center - support + 0.5));
        int xmax = std::min(in_size, int(center + support + 0.5));
        double wsum = 0.0;
        for (int x = xmin; x < xmax; ++x) {
            double arg = (x - center + 0.5) / filterscale;
            double wgt = (arg < 0 ? 1.0 + arg : 1.0 - arg);
            if (wgt < 0) wgt = 0;
            c.weights[size_t(xx) * kmax + (x - xmin)] = wgt;
            wsum += wgt;
        }
        if (wsum > 0)
            for (int k = 0; k < xmax - xmin; ++k) c.weights[size_t(xx) * kmax + k] /= wsum;
        c.xmin[xx] = xmin;
        c.xlen[xx] = xmax - xmin;
    }
    return c;
}

}  // namespace

extern "C" {

// Decode an image byte buffer to RGB8. Returns a malloc'd pointer (caller
// frees with lvc_free) or nullptr; writes height/width.
uint8_t* lvc_decode(const uint8_t* data, long len, int* h, int* w) {
    return decode_any(data, size_t(len), h, w);
}

void lvc_free(uint8_t* p) { free(p); }

// PIL-convention triangle-filter resize, RGB8 -> RGB8. f32 accumulation
// (within the +-1 LSB tolerance vs PIL's fixed point; 2x the SIMD width of
// the earlier double math), and the vertical pass runs row-major — n
// contiguous fused multiply-add sweeps per output row instead of a strided
// k-loop per pixel — so the compiler vectorizes both hot loops.
void lvc_resize(const uint8_t* src, int sh, int sw, int c,
                uint8_t* dst, int dh, int dw) {
    Coeffs cx = precompute(sw, dw);
    Coeffs cy = precompute(sh, dh);
    const size_t rw = size_t(dw) * c;
    std::vector<float> wxf(cx.weights.begin(), cx.weights.end());
    std::vector<float> wyf(cy.weights.begin(), cy.weights.end());
    if (dw >= sw && dh >= sh) {
        // upsampling on both axes: every output is a two-tap bilinear —
        // one fused pass per direction (the detection pipeline's common
        // case: COCO short side ~480-640 resized up to 800)
        struct Tap { int x0, x1; float w0, w1; };
        std::vector<Tap> tx(dw), ty(dh);
        for (int xx = 0; xx < dw; ++xx) {
            const float* w = &wxf[size_t(xx) * cx.kmax];
            int x0 = cx.xmin[xx];
            tx[xx] = {x0, std::min(x0 + 1, sw - 1), w[0],
                      cx.xlen[xx] > 1 ? w[1] : 0.0f};
        }
        for (int yy = 0; yy < dh; ++yy) {
            const float* w = &wyf[size_t(yy) * cy.kmax];
            int y0 = cy.xmin[yy];
            ty[yy] = {y0, std::min(y0 + 1, sh - 1), w[0],
                      cy.xlen[yy] > 1 ? w[1] : 0.0f};
        }
        std::vector<float> hbuf(size_t(sh) * rw);
        for (int y = 0; y < sh; ++y) {
            const uint8_t* row = src + size_t(y) * sw * c;
            float* orow = hbuf.data() + size_t(y) * rw;
            for (int xx = 0; xx < dw; ++xx) {
                const Tap t = tx[xx];
                const uint8_t* s0 = row + size_t(t.x0) * c;
                const uint8_t* s1 = row + size_t(t.x1) * c;
                float* o = orow + size_t(xx) * c;
                for (int ch = 0; ch < c; ++ch)
                    o[ch] = t.w0 * float(s0[ch]) + t.w1 * float(s1[ch]);
            }
        }
        for (int yy = 0; yy < dh; ++yy) {
            const Tap t = ty[yy];
            const float* r0 = hbuf.data() + size_t(t.x0) * rw;
            const float* r1 = hbuf.data() + size_t(t.x1) * rw;
            uint8_t* orow = dst + size_t(yy) * rw;
            for (size_t x = 0; x < rw; ++x) {
                int v = int(t.w0 * r0[x] + t.w1 * r1[x] + 0.5f);
                orow[x] = uint8_t(std::clamp(v, 0, 255));
            }
        }
        return;
    }
    // horizontal pass into float rows
    std::vector<float> tmp(size_t(sh) * rw);
    for (int y = 0; y < sh; ++y) {
        const uint8_t* row = src + size_t(y) * sw * c;
        float* orow = tmp.data() + size_t(y) * rw;
        for (int xx = 0; xx < dw; ++xx) {
            const float* wts = &wxf[size_t(xx) * cx.kmax];
            const uint8_t* s = row + size_t(cx.xmin[xx]) * c;
            const int n = cx.xlen[xx];
            float* o = orow + size_t(xx) * c;
            for (int ch = 0; ch < c; ++ch) o[ch] = 0.0f;
            for (int k = 0; k < n; ++k) {
                const float w = wts[k];
                for (int ch = 0; ch < c; ++ch) o[ch] += w * float(s[k * c + ch]);
            }
        }
    }
    // vertical pass: contiguous row FMAs, then round+clamp
    std::vector<float> acc(rw);
    for (int yy = 0; yy < dh; ++yy) {
        const float* wts = &wyf[size_t(yy) * cy.kmax];
        const int y0 = cy.xmin[yy], n = cy.xlen[yy];
        std::fill(acc.begin(), acc.end(), 0.0f);
        for (int k = 0; k < n; ++k) {
            const float w = wts[k];
            const float* trow = tmp.data() + size_t(y0 + k) * rw;
            for (size_t x = 0; x < rw; ++x) acc[x] += w * trow[x];
        }
        uint8_t* orow = dst + size_t(yy) * rw;
        for (size_t x = 0; x < rw; ++x) {
            int v = int(acc[x] + 0.5f);
            orow[x] = uint8_t(std::clamp(v, 0, 255));
        }
    }
}

// Read + decode + shortest-edge resize in one GIL-free call.
// Returns malloc'd RGB8 (resized_h, resized_w, 3); d2 ResizeShortestEdge
// sizing rule incl. the +0.5 rounding (data/transforms.py:17-38).
uint8_t* lvc_load_resize(const char* path, int short_edge, int max_size,
                         int* out_h, int* out_w, int* orig_h, int* orig_w) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<uint8_t> buf(len);
    if (fread(buf.data(), 1, len, f) != size_t(len)) {
        fclose(f);
        return nullptr;
    }
    fclose(f);
    int h, w;
    uint8_t* img = decode_any(buf.data(), len, &h, &w);
    if (!img) return nullptr;
    *orig_h = h;
    *orig_w = w;
    if (short_edge <= 0) {  // decode only
        *out_h = h;
        *out_w = w;
        return img;
    }
    double scale = double(short_edge) / std::min(h, w);
    double newh = h < w ? short_edge : scale * h;
    double neww = h < w ? scale * w : short_edge;
    if (std::max(newh, neww) > max_size) {
        double s2 = double(max_size) / std::max(newh, neww);
        newh *= s2;
        neww *= s2;
    }
    int dh = int(newh + 0.5), dw = int(neww + 0.5);
    if (dh == h && dw == w) {
        *out_h = h;
        *out_w = w;
        return img;
    }
    uint8_t* out = static_cast<uint8_t*>(malloc(size_t(dh) * dw * 3));
    lvc_resize(img, h, w, 3, out, dh, dw);
    free(img);
    *out_h = dh;
    *out_w = dw;
    return out;
}

}  // extern "C"
