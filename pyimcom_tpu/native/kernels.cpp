// Native host kernels for pyimcom_tpu.
//
// The reference pipeline ships its hot host loops as a C extension
// (furry_parakeet: pyimcom_croutines.iD5512C family,
// pyimcom_interface.bilinear_interpolation/_transpose).  The device compute
// path here is XLA, but the HOST still interpolates PSF samples (batched
// group sampling feeds the on-device overlap spectra) and runs the
// destriping bilinear pair on CPU-only hosts -- this file is the native
// equivalent for those loops, ~an order of magnitude over the vectorized
// numpy twins on one core because the 10x10 (or 8x8) patch never
// materializes as an (N, size, size) temporary.
//
// Contracts are pinned by the numpy twins: ops/interp.interp2d_np /
// kernel_weights_np (reference routine.py:29-181) and
// imdestripe._bilinear_gather_np / bilinear_scatter_adjoint
// (reference pyimcom_interface bilinear pair).  tests/test_native.py
// asserts parity against both.
//
// Plain C ABI (ctypes; no pybind11 in this environment).  All arrays are
// contiguous C-order float64.

#include <cmath>
#include <cstdint>

namespace {

// Degree-9 interpolation kernel coefficients, even/odd split, highest
// power of fh^2 first -- identical constants to ops/interp.py
// (D5512_EVEN/ODD define the scheme; G4460 is the re-derived 8-tap
// L2-optimal family).
const double D5512_EVEN[5][5] = {
    {+1.651881673372979740e-05, -3.145538007199505447e-04, +1.793518183780194427e-03,
     -2.904014557029917318e-03, +6.187591260980151433e-04},
    {-1.146756217210629335e-04, +2.883845374976550142e-03, -1.857047531896089884e-02,
     +3.147734488597204311e-02, -6.753293626461192439e-03},
    {+3.256838096371517067e-04, -9.702063770653997568e-03, +8.678848026470635524e-02,
     -1.659182651092198924e-01, +3.620560878249733799e-02},
    {-4.541830837949564726e-04, +1.494862093737218955e-02, -1.668775957435094937e-01,
     +5.879306056792649171e-01, -1.367845996704077915e-01},
    {+2.266560930061513573e-04, -7.815848920941316502e-03, +9.686607348538181506e-02,
     -4.505856722239036105e-01, +6.067135256905490381e-01},
};
const double D5512_ODD[5][5] = {
    {-3.486978652054735998e-06, +6.753750285320532433e-05, -3.871378836550175566e-04,
     +6.279918076641771273e-04, -1.338434614116611838e-04},
    {+3.121412120355294799e-05, -8.040343683015897672e-04, +5.209574765466357636e-03,
     -8.847326408846412429e-03, +1.898674086370833597e-03},
    {-1.243658986204533102e-04, +3.804930695189636097e-03, -3.434861846914529643e-02,
     +6.581033749134083954e-02, -1.436476114189205733e-02},
    {+2.894406669584551734e-04, -9.794291009695265532e-03, +1.104231510875857830e-01,
     -3.906954914039130755e-01, +9.092432925988773451e-02},
    {-4.336085507644610966e-04, +1.537862263741893339e-02, -1.925091434770601628e-01,
     +8.993141455798455697e-01, -1.213035309579723942e+00},
};
const double G4460_EVEN[4][5] = {
    {-1.945235823911159925e-05, +1.055874006170703754e-03, -8.118995675262492134e-03,
     +1.453840359289597893e-02, -3.143522062829661335e-03},
    {+8.999088401166260235e-05, -5.148137838987351493e-03, +6.069481712095783216e-02,
     -1.235960532055178779e-01, +2.718540716184886588e-02},
    {-1.540666237308310749e-04, +9.123606051920359755e-03, -1.334507380042637137e-01,
     +5.336865231190287551e-01, -1.252224819511615628e-01},
    {+8.351472709485021652e-05, -5.031103870555608815e-03, +8.087359556892606549e-02,
     -4.246267565082386120e-01, +6.011801467479378491e-01},
};
const double G4460_ODD[4][5] = {
    {+7.260754694387638895e-06, -2.904202176384821071e-04, +2.238241587784505285e-03,
     -4.005111027206044276e-03, +8.423052633873124011e-04},
    {-4.631632696889089514e-05, +1.991059241797971720e-03, -2.378440273076087505e-02,
     +4.853753882315355733e-02, -1.053588105750352319e-02},
    {+1.308916996808606444e-04, -5.896228276277161624e-03, +8.761981577498251239e-02,
     -3.533315658835169404e-01, +8.255813013281140811e-02},
    {-2.118650110726590574e-04, +9.766034727710315444e-03, -1.596037936464457796e-01,
     +8.453409395243187685e-01, -1.200891120242346455e+00},
};

// w[k] = e_k + o_k, w[size-1-k] = e_k - o_k with e/o degree-4 polynomials
// in fh^2 (odd additionally * fh); fh = x - floor(x) - 0.5.
inline void weights(double fh, int kern, double* w, int* size) {
    const double f2 = fh * fh;
    if (kern == 0) {  // D5512, 10 taps
        *size = 10;
        for (int k = 0; k < 5; ++k) {
            const double* ce = D5512_EVEN[k];
            const double* co = D5512_ODD[k];
            double e = (((ce[0] * f2 + ce[1]) * f2 + ce[2]) * f2 + ce[3]) * f2 + ce[4];
            double o = ((((co[0] * f2 + co[1]) * f2 + co[2]) * f2 + co[3]) * f2 + co[4]) * fh;
            w[k] = e + o;
            w[9 - k] = e - o;
        }
    } else {          // G4460, 8 taps
        *size = 8;
        for (int k = 0; k < 4; ++k) {
            const double* ce = G4460_EVEN[k];
            const double* co = G4460_ODD[k];
            double e = (((ce[0] * f2 + ce[1]) * f2 + ce[2]) * f2 + ce[3]) * f2 + ce[4];
            double o = ((((co[0] * f2 + co[1]) * f2 + co[2]) * f2 + co[3]) * f2 + co[4]) * fh;
            w[k] = e + o;
            w[7 - k] = e - o;
        }
    }
}

}  // namespace

extern "C" {

// Interpolate L layers (images: L x ny x nx) at n scattered points.
// out: (L, n) C-order.  kern: 0 = D5512 (lo 4, hi 5), 1 = G4460 (lo 3,
// hi 4).  Out-of-range queries write 0 (ops/interp._split_query contract).
int pimc_interp2d_multi(const double* images, int64_t L, int64_t ny,
                        int64_t nx, const double* x, const double* y,
                        int64_t n, int kern, double* out) {
    const int lo = kern == 0 ? 4 : 3;
    const int hi = kern == 0 ? 5 : 4;
    const int64_t plane = ny * nx;
    double wx[10], wy[10];
    int size;
    for (int64_t q = 0; q < n; ++q) {
        const double xq = x[q], yq = y[q];
        const int64_t xi = (int64_t)std::floor(xq);
        const int64_t yi = (int64_t)std::floor(yq);
        if (xi < lo || xi >= nx - hi || yi < lo || yi >= ny - hi) {
            for (int64_t l = 0; l < L; ++l) out[l * n + q] = 0.0;
            continue;
        }
        weights(xq - (double)xi - 0.5, kern, wx, &size);
        weights(yq - (double)yi - 0.5, kern, wy, &size);
        const int64_t base = (yi - lo) * nx + (xi - lo);
        for (int64_t l = 0; l < L; ++l) {
            const double* img = images + l * plane + base;
            double acc = 0.0;
            for (int i = 0; i < size; ++i) {
                const double* row = img + (int64_t)i * nx;
                double r = 0.0;
                for (int j = 0; j < size; ++j) r += row[j] * wx[j];
                acc += r * wy[i];
            }
            out[l * n + q] = acc;
        }
    }
    return 0;
}

// Bilinear gather with optional gain weighting (geff may be null).
// Matches imdestripe._bilinear_gather_np: valid region excludes the last
// row/column; out-of-bounds -> 0; with geff, taps are gain-weighted and
// normalized (zero norm -> unnormalized 0 contribution).
int pimc_bilinear_gather(const double* image, int64_t ny, int64_t nx,
                         const double* xf, const double* yf, int64_t n,
                         const double* geff, double* out) {
    for (int64_t q = 0; q < n; ++q) {
        const double xq = xf[q], yq = yf[q];
        const int64_t x0 = (int64_t)std::floor(xq);
        const int64_t y0 = (int64_t)std::floor(yq);
        if (x0 < 0 || x0 >= nx - 1 || y0 < 0 || y0 >= ny - 1) {
            out[q] = 0.0;
            continue;
        }
        const double fx = xq - (double)x0, fy = yq - (double)y0;
        const double w00 = (1 - fx) * (1 - fy), w10 = fx * (1 - fy);
        const double w01 = (1 - fx) * fy, w11 = fx * fy;
        const int64_t i00 = y0 * nx + x0;
        if (geff) {
            const double g00 = geff[i00], g10 = geff[i00 + 1];
            const double g01 = geff[i00 + nx], g11 = geff[i00 + nx + 1];
            double norm = w00 * g00 + w10 * g10 + w01 * g01 + w11 * g11;
            if (!(norm > 0)) norm = 1.0;
            out[q] = (w00 * g00 * image[i00] + w10 * g10 * image[i00 + 1]
                      + w01 * g01 * image[i00 + nx]
                      + w11 * g11 * image[i00 + nx + 1]) / norm;
        } else {
            out[q] = w00 * image[i00] + w10 * image[i00 + 1]
                     + w01 * image[i00 + nx] + w11 * image[i00 + nx + 1];
        }
    }
    return 0;
}

// Exact adjoint of the unweighted gather: scatter-add each value with the
// same four weights.  out (ny x nx) must be zero-initialized by the
// caller (accumulates, matching np.add.at semantics).
int pimc_bilinear_scatter_adjoint(const double* values, const double* xf,
                                  const double* yf, int64_t n, int64_t ny,
                                  int64_t nx, double* out) {
    for (int64_t q = 0; q < n; ++q) {
        const double xq = xf[q], yq = yf[q];
        const int64_t x0 = (int64_t)std::floor(xq);
        const int64_t y0 = (int64_t)std::floor(yq);
        if (x0 < 0 || x0 >= nx - 1 || y0 < 0 || y0 >= ny - 1) continue;
        const double fx = xq - (double)x0, fy = yq - (double)y0;
        const double v = values[q];
        const int64_t i00 = y0 * nx + x0;
        out[i00] += v * (1 - fx) * (1 - fy);
        out[i00 + 1] += v * fx * (1 - fy);
        out[i00 + nx] += v * (1 - fx) * fy;
        out[i00 + nx + 1] += v * fx * fy;
    }
    return 0;
}

}  // extern "C"
