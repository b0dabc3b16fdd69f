// The GARF render kernel K6 (`garf_render.cuh`) for the sarf activation
// family, fp32 and bf16.
#include "garf_render.cuh"

namespace netpu {
namespace garf {

cudaError_t render_sarf(const RenderArgs& a, bool bf16) { return render_family<kSarf>(a, bf16); }

}  // namespace garf
}  // namespace netpu
