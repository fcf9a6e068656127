// pr_io.cc — native ingest helpers of the PyTorch port (host code).
//
// The host-side ingest path must keep the card fed at hundreds of MB/s
// while the host CPU may be weak; these routines do the only nontrivial CPU work
// in the pipeline (sample-format conversion and channel de-multiplexing) in
// tight single-pass loops. Exposed as a plain C ABI consumed through ctypes
// (passiveradar_torch/io/native.py, which builds it with g++ into
// csrc/build/), with numpy fallbacks when the shared library is
// unavailable.
//
// Layout conventions match the reference capture formats:
//   * separate-channel captures: per channel a float32 (or int16) stream of
//     interleaved IQ [I0, Q0, I1, Q1, ...]  (reference PRconfig.yaml:14-18)
//   * interleaved captures: one stream [refI, refQ, srvI, srvQ, ...]
//     (reference main.py:46-75, PRconfig.yaml:6-12)

#include <cstddef>
#include <cstdint>

extern "C" {

// int16 interleaved IQ → float32 pairs (complex64 memory layout).
void pr_i16_to_f32(const int16_t* in, float* out, size_t n, float scale) {
  for (size_t i = 0; i < n; ++i) {
    out[i] = static_cast<float>(in[i]) * scale;
  }
}

// One interleaved 2-channel float32 stream → two complex64-layout streams.
// in has 4*n_pairs floats: [refI, refQ, srvI, srvQ, ...]; ref/srv each get
// 2*n_pairs floats.
void pr_f32_demux2(const float* in, float* ref, float* srv, size_t n_pairs) {
  for (size_t i = 0; i < n_pairs; ++i) {
    const float* p = in + 4 * i;
    ref[2 * i] = p[0];
    ref[2 * i + 1] = p[1];
    srv[2 * i] = p[2];
    srv[2 * i + 1] = p[3];
  }
}

// Same demux from an int16 stream, fused with the float conversion.
void pr_i16_demux2(const int16_t* in, float* ref, float* srv, size_t n_pairs,
                   float scale) {
  for (size_t i = 0; i < n_pairs; ++i) {
    const int16_t* p = in + 4 * i;
    ref[2 * i] = static_cast<float>(p[0]) * scale;
    ref[2 * i + 1] = static_cast<float>(p[1]) * scale;
    srv[2 * i] = static_cast<float>(p[2]) * scale;
    srv[2 * i + 1] = static_cast<float>(p[3]) * scale;
  }
}

}  // extern "C"
