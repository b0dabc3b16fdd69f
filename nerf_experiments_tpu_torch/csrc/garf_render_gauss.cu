// The GARF render kernel K6 (`garf_render.cuh`) for the gauss activation
// family, fp32 and bf16.
#include "garf_render.cuh"

namespace netpu {
namespace garf {

cudaError_t render_gauss(const RenderArgs& a, bool bf16) { return render_family<kGauss>(a, bf16); }

}  // namespace garf
}  // namespace netpu
