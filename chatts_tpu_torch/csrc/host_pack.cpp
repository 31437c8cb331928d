// Native host-side packing for the port's ChatTS processor: the port's own
// copy of the scatter-map builder of csrc/host_pack.cpp.  Host code, built
// with g++ by chatts_tpu_torch/utils/native.py and bound with ctypes; the
// numpy path in chatts_tpu_torch/processor/processor.py gives the same map
// when the library is not built.

#include <cstdint>

extern "C" {

// Fill the (series, patch) -> (sequence, token) scatter map used by the
// embedding merge.  starts[i] is the placeholder-run start offset of series i
// inside its sequence seq_of[i]; invalid slots get the OOB sentinel
// (seq_sentinel, tok_sentinel) so the device scatter drops them.
int build_scatter_map(
    const int32_t* patch_cnt,
    const int32_t* seq_of,
    const int32_t* starts,
    int64_t n,
    int64_t n_pad,
    int64_t p_max,
    int32_t seq_sentinel,
    int32_t tok_sentinel,
    int32_t* scatter_seq_out,
    int32_t* scatter_tok_out) {
  for (int64_t i = 0; i < n_pad; ++i) {
    const int32_t pc = (i < n) ? patch_cnt[i] : 0;
    int32_t* srow = scatter_seq_out + i * p_max;
    int32_t* trow = scatter_tok_out + i * p_max;
    for (int64_t p = 0; p < p_max; ++p) {
      if (i < n && p < pc) {
        srow[p] = seq_of[i];
        trow[p] = starts[i] + static_cast<int32_t>(p);
      } else {
        srow[p] = seq_sentinel;
        trow[p] = tok_sentinel;
      }
    }
  }
  return 0;
}

}  // extern "C"
