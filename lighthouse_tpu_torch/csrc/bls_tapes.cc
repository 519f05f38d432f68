// The group kernels' tapes (csrc/bls12_381.cuh), built on the host with g++
// and bound with ctypes (lighthouse_tpu_torch/ops/bls_cuda.py), which hands
// the blob to csrc/bls12_381.cu before its first group launch.  The card so
// runs the very tapes that the CPU tests run through the header's host
// versions of the group kernels (host_miller, ...).

#include <cstring>

#include "bls12_381.cuh"

using namespace bls;

extern "C" {

long long lh_tapes_size() { return (long long)sizeof(Tapes); }

// out: lh_tapes_size() bytes; returns the build's error flag
int lh_build_tapes(void* out) {
    const Tapes& t = host_tapes();
    std::memcpy(out, &t, sizeof(Tapes));
    return t.error;
}

// out: the tapes' shape (tape_stats: TAPE_STATS ints), then the Fp slots of
// a lane's workspace in k_gj_scalar_mul, k_g1_scalar_mul, k_miller,
// k_fq12_mul(_halves), k_final_exp_hard, k_g2_subgroup and k_g1_subgroup,
// then their group widths
void lh_tape_stats(int* out) {
    tape_stats(host_tapes(), out);
    const int more[14] = {GJ_WS, G1_WS, MILLER_WS, FQ12_WS, FE_WS, PSI_WS, GS_WS,
                          GJ_W,  G1_W,  MILLER_W,  FQ12_W,  FE_W,  PSI_W,  G1_W};
    std::memcpy(out + TAPE_STATS, more, sizeof(more));
}

}  // extern "C"
