// Native JPEG decode core for the host input pipeline (the port's copy of
// upgpt_tpu/native/jpeg_core.cpp).
//
// The reference feeds its GPU through torch DataLoader worker processes
// (reference main.py:208-250) whose decode work happens in torch/PIL's C
// layers. The thread-pool loader (PrefetchDataLoader) decodes at the serial
// rate through PIL, whose JPEG path holds the GIL through most of each item;
// the process-pool loader works around it at the cost of spawn time and
// pickle transport. This core decodes through libjpeg directly behind a C
// ABI so the ctypes call releases the GIL for the whole decode: the thread
// loader then parallelizes across real cores with no IPC.
//
// Output is RGB888, bit-exact with PIL's decode of the same file (both are
// libjpeg with default JDCT_ISLOW; asserted in tests/test_torch_data.py and
// by the loader's first-load probe).

#include <cstddef>
#include <cstdio>
#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>

namespace {

// libjpeg's default error handler calls exit(); trampoline to longjmp so
// a corrupt file surfaces as a return code the Python side can turn into
// a PIL fallback instead of killing the trainer.
struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void err_exit(j_common_ptr cinfo) {
  ErrMgr* e = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(e->jump, 1);
}

}  // namespace

extern "C" {

// Parse the header only (cheap): fills *h/*w, returns 0 on success.
int upgpt_jpeg_header(const uint8_t* data, size_t size, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  *h = static_cast<int>(cinfo.image_height);
  *w = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode to RGB888 into a caller buffer of out_h*out_w*3 bytes (the
// caller sizes it from upgpt_jpeg_header). Grayscale/CMYK sources are
// converted by libjpeg (out_color_space = JCS_RGB), matching PIL's
// convert("RGB") for baseline files. Returns 0 on success, nonzero on
// malformed input or a dimension mismatch.
int upgpt_decode_jpeg(const uint8_t* data, size_t size, uint8_t* out,
                      int out_h, int out_w) {
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), size);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return 3;
  }
  const size_t stride = static_cast<size_t>(out_w) * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
