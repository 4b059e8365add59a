// One 30 Hz control step for every env in one launch: sim_steps x substeps
// substeps, each = heightfield contact -> PD torque (5 control modes, hard
// or soft joint limits) -> Featherstone ABA with a Schur 6x6 root solve ->
// semi-implicit Euler with exp-map quat updates -> FK of body pos/rot/lin
// vel/ang vel. The per-env math is csrc/substep_math.cuh.
//
// Replaces two pieces of the TPU side: the kernel
// parc_tpu/physics/pallas_substep.py::_substep_kernel (one launch per
// substep, from control_step_pallas) and the contact pass that ran in XLA
// between those launches (parc_tpu/physics/engine.py::compute_contact_forces).
// On the TPU contact stayed outside the kernel because its gathers ran as
// MXU one-hots; here a lane reads its point's body rows from shared memory.
//
// What bounds it on an H100. On paper, the operations: at 4096 envs one
// launch reads (292 + 84) rows and writes (292 + 45) rows of 4096 f32 plus
// the terrain index, the model table and the heightfield, about 11.7 MB
// (3.5 us at 3.35 TB/s), and does four substeps of about 29k f32
// operations per env (52 contact points, PD, ABA, integration, FK), about
// 480 M operations (7.2 us at the card's 67 TFLOP/s outside the tensor
// cores). In practice, the instruction rate: the work is many tiny
// dependent 3x3 and 6x6 products along a tree, so only the lanes of the
// bodies on one level of the tree are busy at a time (3-5 of 16 for the
// humanoid), and the 16 warps an SM holds share its four schedulers. The
// phase clock (physics/substep.py phase_cycles, chip_smoke.py phase 3f)
// puts 43 % of a substep in the inward pass on the H100, 11 % in the
// contact points and 10 % or less in each other stage.
//
// Design:
// * A team of lanes per env, one lane per body: the team width is the next
//   power of two >= the body count (16 for the humanoid, two envs to a
//   warp). A lane keeps its body's work of a pass in registers and hands
//   what the next pass needs to its body's slots in shared memory, never
//   to per-thread local arrays (the one-thread-per-env kernel this
//   replaced kept 15 KB of them a thread, in device memory). The tree
//   passes go one level per step (five levels for the humanoid in place of
//   fifteen bodies in turn), with the articulated inertias handed to the
//   parent through shared memory and summed in a fixed child order, and
//   the 52 contact points split over the lanes, each body summing its own
//   points in order. No atomics: two launches give the same bits.
// * The whole control step stays on chip: a block of E envs stages its
//   [C, E] tile of the state and PD targets into shared memory with
//   cp.async (neighbouring threads on neighbouring addresses), runs the
//   four substeps on it and writes the new state and the contact forces
//   back once. The model table is copied into shared memory once per block.
// * One wave: blocks of 128 threads (8 humanoid envs, 55 KB of shared
//   memory), 4096 envs in 512 blocks, 4 blocks to an SM, so every env is
//   resident at once on the 132 SMs. That caps a thread at 128 registers;
//   the code is arranged to fit them without spilling (a build allowed 168
//   registers, 3 blocks to an SM, took two waves and ran slower).
// * The model is data: tree, level schedule, dynamics and contact tables
//   come from the packed table, bounded at kMaxBodies bodies and
//   kMaxContactPoints points (the wrapper and the launcher check), so
//   another character runs without a rebuild.
#include <cuda_runtime.h>

#include "substep_math.cuh"

#ifdef PARC_PHASE_CLOCKS
// cycles of each substep stage, summed over the blocks (parc::Team::sync)
__device__ unsigned long long g_phase_cycles[parc::kPhases];
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 4;  // blocks per SM the register budget is cut for

__host__ __device__ inline int team_width(int nb) {
  int w = 1;
  while (w < nb) w *= 2;
  return w;
}

// floats of a block's dynamic shared memory: model tables, then per env
// its column of state and const rows (padded to an odd pitch), its
// inertia slots, its contact-point / keep area and its spatial vectors
struct SmemLayout {
  int ftab, itab, pitch, per_env, envs, total;
  __host__ __device__ SmemLayout(int nb, int nd, int np) {
    const parc::Rows R(nb, nd);
    ftab = parc::ftab_size(nb, nd, np);
    itab = parc::itab_size(nb, np);
    pitch = R.total | 1;
    per_env = pitch + parc::kSlotStride * nb + parc::pt_size(nb, np) + 6 * nb;
    envs = kThreads / team_width(nb);
    total = ftab + itab + envs * per_env;
  }
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
control_step_kernel(const float* __restrict__ state, const float* __restrict__ cnst,
                    float* __restrict__ out, float* __restrict__ contact,
                    const int* __restrict__ itab, const float* __restrict__ ftab,
                    parc::Terrain ter, const int* __restrict__ tidx, int n,
                    int nb, int nd, int np, parc::StepParams p) {
  extern __shared__ float smem[];
  const SmemLayout L(nb, nd, np);
  const parc::Rows R(nb, nd);
  const int width = team_width(nb);
  const int E = L.envs;
  float* s_ftab = smem;
  int* s_itab = reinterpret_cast<int*>(smem + L.ftab);
  float* envs = smem + L.ftab + L.itab;
  const int base = blockIdx.x * E;

  // model tables: plain loads; the tile: cp.async, row-major over the
  // block's E envs so that neighbouring threads read neighbouring addresses
  for (int i = threadIdx.x; i < L.ftab; i += kThreads) s_ftab[i] = ftab[i];
  for (int i = threadIdx.x; i < L.itab; i += kThreads) s_itab[i] = itab[i];
  const int rows_in = R.state + R.cnst;
  for (int i = threadIdx.x; i < rows_in * E; i += kThreads) {
    const int c = i / E, e = i % E;
    const int env = min(base + e, n - 1);  // past the end: repeat the last env
    const float* src = c < R.state ? state + static_cast<long>(c) * n + env
                                   : cnst + static_cast<long>(c - R.state) * n + env;
    cp_async4(envs + e * L.per_env + c, src);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int team = threadIdx.x / width;
  float* mine = envs + team * L.per_env;
  const parc::Scratch sc{mine, mine + L.pitch,
                         mine + L.pitch + parc::kSlotStride * nb,
                         mine + L.pitch + parc::kSlotStride * nb + parc::pt_size(nb, np)};
  const parc::Model m(s_itab, s_ftab);
  const int env = min(base + team, n - 1);
  parc::Team lanes{static_cast<int>(threadIdx.x) % width, width};
#if defined(PARC_PHASE_CLOCKS) && defined(__CUDA_ARCH__)
  lanes.clocks = g_phase_cycles;
  lanes.since = clock64();
#endif
  parc::control_step_team<1>(lanes, m, sc, ter, ter.index(tidx[env]), p,
                             base + team < n ? contact + base + team : nullptr, n);
  __syncthreads();

  for (int i = threadIdx.x; i < R.state * E; i += kThreads) {
    const int c = i / E, e = i % E;
    if (base + e < n) out[static_cast<long>(c) * n + base + e] = envs[e * L.per_env + c];
  }
}

}  // namespace

// fparams, iparams: the step's scalars (parc::step_params). Returns a CUDA
// error code (cudaErrorInvalidValue for a model past the kernel's bounds).
extern "C" int parc_control_step_launch(
    const void* state, const void* cnst, void* out, void* contact,
    const void* itab, const void* ftab, int nb, int nd, int np,
    const void* hf, const void* min_point, const void* dxdy, int n_terrains,
    int hf_h, int hf_w,
    const void* tidx, int n, const float* fparams, const int* iparams,
    void* stream) {
  if (n <= 0) return 0;
  if (n_terrains < 1 || hf_h < 2 || hf_w < 2 || nb < 1 || nb > parc::kMaxBodies || np > parc::kMaxContactPoints || nd < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const SmemLayout L(nb, nd, np);
  const size_t smem = sizeof(float) * static_cast<size_t>(L.total);
  // above 48 KB a block's shared memory must be asked for; the largest
  // carveout lets kMinBlocks blocks share an SM
  cudaError_t rc = cudaFuncSetAttribute(
      control_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(control_step_kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const parc::StepParams p = parc::step_params(fparams, iparams);
  parc::Terrain ter{static_cast<const float*>(hf), static_cast<const float*>(min_point),
                    static_cast<const float*>(dxdy), n_terrains, hf_h, hf_w};
  const int blocks = (n + L.envs - 1) / L.envs;
  control_step_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(state), static_cast<const float*>(cnst),
      static_cast<float*>(out), static_cast<float*>(contact),
      static_cast<const int*>(itab), static_cast<const float*>(ftab), ter,
      static_cast<const int*>(tidx), n, nb, nd, np, p);
  return static_cast<int>(cudaGetLastError());
}

// the launch's grid and shared memory, for reports
extern "C" int parc_control_step_blocks(int n, int nb) {
  const int envs = kThreads / team_width(nb);
  return (n + envs - 1) / envs;
}

extern "C" int parc_control_step_smem_bytes(int nb, int nd, int np) {
  return static_cast<int>(sizeof(float)) * SmemLayout(nb, nd, np).total;
}

extern "C" int parc_max_bodies() { return parc::kMaxBodies; }
extern "C" int parc_phases() { return parc::kPhases; }

#ifdef PARC_PHASE_CLOCKS
// the phase clock's cycles since the last call (into out[kPhases]), then
// zeroed; the launches must have finished
extern "C" int parc_phase_cycles(unsigned long long* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  const unsigned long long zero[parc::kPhases] = {};
  if (rc == cudaSuccess) rc = cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero));
  return static_cast<int>(rc);
}
#endif
extern "C" int parc_max_contact_points() { return parc::kMaxContactPoints; }
