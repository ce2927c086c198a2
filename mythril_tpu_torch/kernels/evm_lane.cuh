// What kernels K1 (its step form, keccak.cu) and K2 (evm_step.cu) both read
// of a lane in K2's parameter block: its opcode, whether it runs this step,
// its stack slots. One copy, so that K1 finds exactly the SHA3 lanes whose
// digest K2 commits.
#pragma once

#include "words.cuh"

namespace {

__device__ __forceinline__ int op_at(const Args& a, int lane, int pc) {
    const int C = arg_int(a, K2_C);
    if (pc >= arg_ptr<int32_t>(a, L_CODE_LEN)[lane]) return OP_STOP;
    int idx = pc < 0 ? 0 : (pc > C - 1 ? C - 1 : pc);
    return arg_ptr<uint8_t>(a, L_CODE)[static_cast<long long>(lane) * C + idx];
}

__device__ __forceinline__ bool running_of(const Args& a, int lane) {
    bool running = arg_ptr<int32_t>(a, L_STATUS)[lane] == ST_RUNNING;
    const uint8_t* fe = arg_ptr<const uint8_t>(a, K2_FORCE_ESCAPE);
    const uint8_t* ff = arg_ptr<const uint8_t>(a, K2_FORCE_FORK);
    if (fe) running = running && !fe[lane] && !ff[lane];
    return running;
}

__device__ __forceinline__ const int32_t* slot_ptr(const Args& a, int lane,
                                                   long long sp, int n) {
    const int S = arg_int(a, K2_S);
    long long idx = sp - n;
    idx = idx < 0 ? 0 : (idx > S - 1 ? S - 1 : idx);
    return arg_ptr<int32_t>(a, L_STACK) + (static_cast<long long>(lane) * S + idx) * 16;
}

__device__ __forceinline__ long long clampll(long long v, long long lo,
                                             long long hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace
