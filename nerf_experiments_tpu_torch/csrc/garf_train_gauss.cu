// The GARF train kernel (`garf_train.cuh`) for the gauss activation family,
// fp32 and bf16.
#include "garf_train.cuh"

namespace netpu {
namespace garf {

cudaError_t train_gauss(const TrainArgs& a, bool bf16) { return train_family<kGauss>(a, bf16); }

}  // namespace garf
}  // namespace netpu
