// The Riccati kernel's group body built for the CPU, for the tests only: the
// same riccati.cuh that nvcc compiles for the card, its G lanes run one
// after another phase by phase over a local tile, looped over instances and
// instantiated for float and double at every stage shape of
// MPC_RICCATI_SHAPES.  Built with `g++ -O2 -shared -fPIC` and loaded with
// ctypes (solver/riccati_kernel.py); the package's main path never loads
// it.
#include "riccati.cuh"

namespace {

template <typename T, int NZ, int NU>
void solve_all(const mpc_riccati::RiccatiArgs<T>& a) {
  typedef mpc_riccati::RicShape<NZ, NU> Sh;
  T tile[Sh::kSize];
  const mpc_riccati::RicGroup<Sh::G> g{0, 0u};
  for (long long b = 0; b < a.B; ++b)
    mpc_riccati::riccati_group<T, NZ, NU>(a, b, g, tile);
}

template <typename T>
int solve(long long B, int N, int nz, int nu, void* const* ptrs) {
  const mpc_riccati::RiccatiArgs<T> a = mpc_riccati::make_args<T>(B, N, ptrs);
#define MPC_RICCATI_CPU(NZ_, NU_)         \
  if (nz == NZ_ && nu == NU_) {           \
    solve_all<T, NZ_, NU_>(a);            \
    return 0;                             \
  }
  MPC_RICCATI_SHAPES(MPC_RICCATI_CPU)
#undef MPC_RICCATI_CPU
  return -1;
}

}  // namespace

extern "C" {

int mpc_riccati_cpu_f32(long long B, int N, int nz, int nu,
                        void* const* ptrs) {
  return solve<float>(B, N, nz, nu, ptrs);
}

int mpc_riccati_cpu_f64(long long B, int N, int nz, int nu,
                        void* const* ptrs) {
  return solve<double>(B, N, nz, nu, ptrs);
}

}  // extern "C"
