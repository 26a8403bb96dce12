// The C interface that tpukern_torch/_build.py loads with ctypes.
//
// One entry point per kernel. Each validates through its launcher, then
// returns cudaGetLastError(), so a launch the driver refuses (too many
// threads, too much shared memory, no image for this card) reaches the
// Python wrapper as an error instead of a silent no-op.
#include "common.cuh"

namespace {
int checked(cudaError_t e) {
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

const char* tk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int tk_rms_norm(const void* x, const void* g, float g_scalar, void* y,
                int64_t rows, int64_t cols, float eps, int acc_bf16,
                int x_dtype, int g_dtype, void* stream) {
  return checked(tk::rms_norm_launch(x, g, g_scalar, y, rows, cols, eps,
                                     acc_bf16, x_dtype, g_dtype,
                                     static_cast<cudaStream_t>(stream)));
}

int tk_rope_cached(const void* x, const void* cos, const void* sin, void* y,
                   int64_t rows, int head_dim, int dtype, void* stream) {
  return checked(tk::rope_cached_launch(x, cos, sin, y, rows, head_dim, dtype,
                                        static_cast<cudaStream_t>(stream)));
}

int tk_rope_batched(const void* x, void* y, int64_t rows, int head_dim,
                    int seq_len, float sign, int dtype, void* stream) {
  return checked(tk::rope_batched_launch(x, y, rows, head_dim, seq_len, sign,
                                         dtype,
                                         static_cast<cudaStream_t>(stream)));
}

int tk_flash_attention(const void* q, const void* k, const void* v, void* o,
                       float* lse, const int* q_seg, const int* kv_seg, int B,
                       int Hq, int Hkv, int Sq, int Skv, int D, float sm_scale,
                       int causal, int window, int sinks, float softcap,
                       int dtype, int config, void* stream) {
  return checked(tk::flash_attention_launch(
      q, k, v, o, lse, q_seg, kv_seg, B, Hq, Hkv, Sq, Skv, D, sm_scale, causal,
      window, sinks, softcap, dtype, config,
      static_cast<cudaStream_t>(stream)));
}

int tk_flash_attention_bwd(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* di,
                           float* dq, void* dk, void* dv, int B, int Hq,
                           int Hkv, int Sq, int Skv, int D, float sm_scale,
                           int causal, int dtype, void* stream) {
  return checked(tk::flash_attention_bwd_launch(
      q, k, v, dout, lse, di, dq, dk, dv, B, Hq, Hkv, Sq, Skv, D, sm_scale,
      causal, dtype, static_cast<cudaStream_t>(stream)));
}

int tk_flash_attention_dq(const void* q, const void* k, const void* v,
                          const void* dout, const float* lse, const float* di,
                          const int* q_seg, const int* kv_seg, void* dq, int B,
                          int Hq, int Hkv, int Sq, int Skv, int D,
                          float sm_scale, int causal, int window,
                          float softcap, int dtype, void* stream) {
  return checked(tk::flash_attention_dq_launch(
      q, k, v, dout, lse, di, q_seg, kv_seg, dq, B, Hq, Hkv, Sq, Skv, D,
      sm_scale, causal, window, softcap, dtype,
      static_cast<cudaStream_t>(stream)));
}

int tk_flash_attention_dkv(const void* q, const void* k, const void* v,
                           const void* dout, const float* lse, const float* di,
                           const int* q_seg, const int* kv_seg, void* dk,
                           void* dv, int B, int Hq, int Hkv, int Sq, int Skv,
                           int D, float sm_scale, int causal, int window,
                           float softcap, int dtype, void* stream) {
  return checked(tk::flash_attention_dkv_launch(
      q, k, v, dout, lse, di, q_seg, kv_seg, dk, dv, B, Hq, Hkv, Sq, Skv, D,
      sm_scale, causal, window, softcap, dtype,
      static_cast<cudaStream_t>(stream)));
}

int tk_matmul(const void* a, const void* b, void* c32, void* c16, int M,
              int N, int K, int trans_b, int dtype, void* scratch, int splits,
              int* tickets, int* passes, void* stream) {
  return checked(tk::matmul_launch(a, b, c32, c16, M, N, K, trans_b, dtype,
                                   scratch, splits, tickets, passes,
                                   static_cast<cudaStream_t>(stream)));
}

int tk_split_tf32(const float* src, int R, int C, int64_t ld, float* out,
                  int64_t ldo, float* outT, int64_t ldoT, int* passes,
                  void* stream) {
  return checked(tk::split_tf32_launch(src, R, C, ld, out, ldo, outT, ldoT,
                                       passes,
                                       static_cast<cudaStream_t>(stream)));
}

int tk_gmm(const void* x, const void* w, const int* group_sizes, void* y32,
           void* y16, int T, int N, int K, int E, int trans_w, int dtype,
           void* scratch, int* passes, void* stream) {
  return checked(tk::gmm_launch(x, w, group_sizes, y32, y16, T, N, K, E,
                                trans_w, dtype, scratch, passes,
                                static_cast<cudaStream_t>(stream)));
}

int tk_tgmm(const void* x, const void* dy, const int* group_sizes, void* o32,
            void* o16, int T, int K, int N, int E, int dtype, void* scratch,
            int* passes, void* stream) {
  return checked(tk::tgmm_launch(x, dy, group_sizes, o32, o16, T, K, N, E,
                                 dtype, scratch, passes,
                                 static_cast<cudaStream_t>(stream)));
}

int tk_matmul_w8a16(const void* x, const void* w, const float* s, void* out,
                    float* ws, int* tickets, int M, int N, int K, int splits,
                    int kt_per, int dtype, int out_dtype, void* stream) {
  return checked(tk::matmul_w8a16_launch(x, w, s, out, ws, tickets, M, N, K,
                                         splits, kt_per, dtype, out_dtype,
                                         static_cast<cudaStream_t>(stream)));
}

int tk_paged_attention(const void* q, const void* k_pages, const void* v_pages,
                       const int* lengths, const int* page_table, void* o,
                       int B, int Hq, int Hkv, int P, int page_size,
                       int pages_per_seq, int D, float sm_scale, int window,
                       int sinks, float softcap, int ring, const float* slopes,
                       int chunk, float* ws, int* tickets, int dtype,
                       void* stream) {
  return checked(tk::paged_attention_launch(
      q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv, P, page_size,
      pages_per_seq, D, sm_scale, window, sinks, softcap, ring, slopes, chunk,
      ws, tickets, dtype, static_cast<cudaStream_t>(stream)));
}

int tk_paged_prefill(const void* q, const void* k_pages, const void* v_pages,
                     const int* lengths, const int* page_table, void* o, int B,
                     int Hq, int Hkv, int T, int P, int page_size,
                     int pages_per_seq, int D, float sm_scale, int window,
                     int sinks, float softcap, int ring, const float* slopes,
                     int chunk, float* ws, int* tickets, int dtype,
                     void* stream) {
  return checked(tk::paged_prefill_launch(
      q, k_pages, v_pages, lengths, page_table, o, B, Hq, Hkv, T, P, page_size,
      pages_per_seq, D, sm_scale, window, sinks, softcap, ring, slopes, chunk,
      ws, tickets, dtype, static_cast<cudaStream_t>(stream)));
}

int tk_paged_prefill_quantized(
    const void* q, const float* q_scales, const void* k_pages,
    const float* k_scales, const void* v_pages, const float* v_scales,
    const int* lengths, const int* page_table, void* o, int B, int Hq, int Hkv,
    int T, int P, int page_size, int pages_per_seq, int D, int block_tokens,
    float sm_scale, int window, int sinks, float softcap, int ring,
    const float* slopes, int chunk, float* ws, int* tickets, float* stats,
    int dtype, int kv_dtype, int pv_int8, void* stream) {
  return checked(tk::paged_prefill_quantized_launch(
      q, q_scales, k_pages, k_scales, v_pages, v_scales, lengths, page_table, o,
      B, Hq, Hkv, T, P, page_size, pages_per_seq, D, block_tokens, sm_scale,
      window, sinks, softcap, ring, slopes, chunk, ws, tickets, stats, dtype,
      kv_dtype, pv_int8, static_cast<cudaStream_t>(stream)));
}

int tk_quantize(const void* x, void* values, float* scales, int64_t S, int K,
                int mode, long long seed, int dtype, void* stream) {
  return checked(tk::quantize_launch(x, values, scales, S, K, mode, seed, dtype,
                                     static_cast<cudaStream_t>(stream)));
}

int tk_dequantize(const void* values, const float* scales, void* out,
                  int64_t S, int K, int dtype, void* stream) {
  return checked(tk::dequantize_launch(values, scales, out, S, K, dtype,
                                       static_cast<cudaStream_t>(stream)));
}

int tk_ce_fwd(const void* x, const void* w, const int* targets, float* part,
              int N, int D, int V, int log2, void* stream) {
  return checked(tk::ce_fwd_launch(x, w, targets, part, N, D, V, log2,
                                   static_cast<cudaStream_t>(stream)));
}

int tk_ce_fwd_f32(const float* x, const float* w, const int* targets,
                  float* part, float* xs, float* ws, int N, int D, int V,
                  int v0, int vc, int tile0, int split_x, int log2,
                  int* passes, void* stream) {
  return checked(tk::ce_fwd_f32_launch(x, w, targets, part, xs, ws, N, D, V,
                                       v0, vc, tile0, split_x, log2, passes,
                                       static_cast<cudaStream_t>(stream)));
}

int tk_ce_combine(const float* part, const int* targets, float* loss,
                  float* lse, int N, int n_split, void* stream) {
  return checked(tk::ce_combine_launch(part, targets, loss, lse, N, n_split,
                                       static_cast<cudaStream_t>(stream)));
}

int tk_ce_bwd(const float* x, const float* w, const int* targets,
              const float* lse, const float* g, float* dx, float* dw,
              float* xs, float* ws, float* ds, int N, int D, int V, int v0,
              int vc, int add, int split_x, int log2, int* passes,
              void* stream) {
  return checked(tk::ce_bwd_launch(x, w, targets, lse, g, dx, dw, xs, ws, ds,
                                   N, D, V, v0, vc, add, split_x, log2, passes,
                                   static_cast<cudaStream_t>(stream)));
}

int tk_ce_bwd_chunk(const void* x, const void* w, const int* targets,
                    const float* lse, const float* g, float* dx, float* dw,
                    void* dlog, int N, int D, int V, int v0, int vc, int add,
                    int log2, void* stream) {
  return checked(tk::ce_bwd_chunk_launch(x, w, targets, lse, g, dx, dw, dlog,
                                         N, D, V, v0, vc, add, log2,
                                         static_cast<cudaStream_t>(stream)));
}

int tk_sample(const void* x, const float* thr, const float* noise, int mode,
              long long seed, float inv_temp, int B, int V, int n_split,
              unsigned long long* part, int* out, int dtype, void* stream) {
  return checked(tk::sample_launch(x, thr, noise, mode, seed, inv_temp, B, V,
                                   n_split, part, out, dtype,
                                   static_cast<cudaStream_t>(stream)));
}

int tk_sample_threshold(const float* x, float* thr, int B, int V, int mode,
                        int kk, float pp, float inv_temp, void* stream) {
  return checked(tk::sample_threshold_launch(
      x, thr, B, V, mode, kk, pp, inv_temp, static_cast<cudaStream_t>(stream)));
}

int tk_ew(int op, const void* x0, const void* x1, const float* s, void* y,
          int64_t n, int vec, int dtype, void* stream) {
  return checked(tk::ew_launch(op, x0, x1, s, y, n, vec, dtype,
                               static_cast<cudaStream_t>(stream)));
}

int tk_reduce(const void* x, const void* y, void* partials, void* out,
              int64_t n, int mode, int in_dtype, int acc_dtype, void* stream) {
  return checked(tk::reduce_launch(x, y, partials, out, n, mode, in_dtype,
                                   acc_dtype,
                                   static_cast<cudaStream_t>(stream)));
}

int tk_matmul_naive(const void* a, const void* b, void* c, int M, int N, int K,
                    int dtype, void* stream) {
  return checked(tk::matmul_naive_launch(a, b, c, M, N, K, dtype,
                                         static_cast<cudaStream_t>(stream)));
}

int tk_softmax(const void* x, void* y, int64_t rows, int64_t cols, int mode,
               int dtype, void* stream) {
  return checked(tk::softmax_launch(x, y, rows, cols, mode, dtype,
                                    static_cast<cudaStream_t>(stream)));
}

int tk_softmax_grid_stats(const void* x, float* pm, float* pd, int64_t rows,
                          int64_t cols, int br, int bc, int ncb, int dtype,
                          void* stream) {
  return checked(tk::softmax_grid_stats_launch(
      x, pm, pd, rows, cols, br, bc, ncb, dtype,
      static_cast<cudaStream_t>(stream)));
}

int tk_softmax_grid_norm(const void* x, const float* pm, const float* pd,
                         void* y, int64_t rows, int64_t cols, int br, int bc,
                         int ncb, int dtype, void* stream) {
  return checked(tk::softmax_grid_norm_launch(
      x, pm, pd, y, rows, cols, br, bc, ncb, dtype,
      static_cast<cudaStream_t>(stream)));
}

int tk_softmax_grid_fused(const void* x, void* y, int64_t rows, int64_t cols,
                          int bc, int ncb, int dtype, void* stream) {
  return checked(tk::softmax_grid_fused_launch(
      x, y, rows, cols, bc, ncb, dtype, static_cast<cudaStream_t>(stream)));
}

int tk_softmax_grid_fused_plan(int64_t rows, int64_t cols, int bc, int ncb,
                               int dtype, int* out) {
  return checked(
      tk::softmax_grid_fused_plan(rows, cols, bc, ncb, dtype, out));
}

int tk_layer_norm(const void* x, const void* g, float g_scalar, const void* b,
                  float b_scalar, void* y, int64_t rows, int64_t cols,
                  float eps, int acc_bf16, int x_dtype, int gb_dtype,
                  void* stream) {
  return checked(tk::layer_norm_launch(x, g, g_scalar, b, b_scalar, y, rows,
                                       cols, eps, acc_bf16, x_dtype, gb_dtype,
                                       static_cast<cudaStream_t>(stream)));
}

int tk_embedding_gather(const int* idx, const void* w, void* out, int64_t S,
                        int V, int64_t D, int block_tokens, int mode,
                        int dtype, void* stream) {
  return checked(tk::embedding_gather_launch(
      idx, w, out, S, V, D, block_tokens, mode, dtype,
      static_cast<cudaStream_t>(stream)));
}

int tk_embedding_onehot(const int* idx, const void* w, void* out, int S,
                        int V, int D, int dtype, void* stream) {
  return checked(tk::embedding_onehot_launch(
      idx, w, out, S, V, D, dtype, static_cast<cudaStream_t>(stream)));
}

int tk_histogram(const int* x, int64_t n, int* out, int bins, int block_rows,
                 void* stream) {
  return checked(tk::histogram_launch(x, n, out, bins, block_rows,
                                      static_cast<cudaStream_t>(stream)));
}

int tk_transpose(const void* x, void* out, int64_t M, int64_t N, int bm,
                 int bn, int order, int dtype, void* stream) {
  return checked(tk::transpose_launch(x, out, M, N, bm, bn, order, dtype,
                                      static_cast<cudaStream_t>(stream)));
}

int tk_gemv(const void* A, const void* x, float* y, int M, int64_t K,
            int64_t bk, int mode, int dtype, void* stream) {
  return checked(tk::gemv_launch(A, x, y, M, K, bk, mode, dtype,
                                 static_cast<cudaStream_t>(stream)));
}

int tk_nms_keep(const float* boxes, int n, float thr, unsigned long long* mask,
                int* keep, void* stream) {
  return checked(tk::nms_keep_launch(boxes, n, thr, mask, keep,
                                     static_cast<cudaStream_t>(stream)));
}

int tk_ring_all_gather(const void* x, void* out, unsigned long long* flags,
                       int n, int64_t chunk_bytes, unsigned long long base,
                       int max_blocks, void* stream) {
  return checked(tk::ring_all_gather_launch(
      x, out, flags, n, chunk_bytes, base, max_blocks,
      static_cast<cudaStream_t>(stream)));
}

int tk_ring_reduce_scatter(const void* x, void* out, void* slots,
                           unsigned long long* flags, int n, int64_t chunk,
                           int dtype, unsigned long long base, int max_blocks,
                           void* stream) {
  return checked(tk::ring_reduce_scatter_launch(
      x, out, slots, flags, n, chunk, dtype, base, max_blocks,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
