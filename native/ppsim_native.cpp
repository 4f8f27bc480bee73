// Native ground-truth engine for ppsim_tpu.
//
// Role (SURVEY.md §2 native-code note): the reference is 100% native C++; the
// JAX rebuild keeps a native oracle so JAX trajectories can be cross-checked
// against an independent, double-precision, CPU implementation — including
// bit-exact validation of the mt19937 initializer against libstdc++.
//
// Design is deliberately NOT the reference's: structure-of-arrays state, a
// counting-sort rebin into flat CSR-style cell lists rebuilt per step (no
// pointer-chasing containers), and a C ABI consumed from Python via ctypes.
//
// Physics contract being mirrored (cited for parity checking):
//   force law / integration / wall bounce: part1/serial.cpp:19-61
//   initializer:                            part1/main.cpp:31-59
//
// Build: see native/CMakeLists.txt, or ppsim_tpu/native.py builds it with a
// single g++ command on demand.

#include <cmath>
#include <cstdint>
#include <random>
#include <vector>

namespace {

struct Params {
    double cutoff;
    double min_r;
    double mass;
    double dt;
};

inline void accumulate_force(double xi, double yi, double xj, double yj,
                             const Params& p, double& ax, double& ay) {
    const double dx = xj - xi;
    const double dy = yj - yi;
    double r2 = dx * dx + dy * dy;
    if (r2 > p.cutoff * p.cutoff)
        return;
    r2 = std::fmax(r2, p.min_r * p.min_r);
    const double r = std::sqrt(r2);
    const double coef = (1.0 - p.cutoff / r) / r2 / p.mass;
    ax += coef * dx;
    ay += coef * dy;
}

inline void integrate(double& x, double& y, double& vx, double& vy, double ax,
                      double ay, double dt, double size) {
    vx += ax * dt;
    vy += ay * dt;
    x += vx * dt;
    y += vy * dt;
    while (x < 0 || x > size) {
        x = x < 0 ? -x : 2 * size - x;
        vx = -vx;
    }
    while (y < 0 || y > size) {
        y = y < 0 ? -y : 2 * size - y;
        vy = -vy;
    }
}

// Flat cell index grid rebuilt per step: counts -> offsets -> fill (CSR).
class CellList {
  public:
    CellList(double size, double cell) {
        side_ = std::max<int64_t>(1, (int64_t)std::ceil(size / cell));
        inv_cell_ = 1.0 / cell;
        counts_.assign(side_ * side_ + 1, 0);
    }

    void build(const double* x, const double* y, int64_t n) {
        cell_of_.resize(n);
        order_.resize(n);
        std::fill(counts_.begin(), counts_.end(), 0);
        for (int64_t i = 0; i < n; ++i) {
            const int64_t cx = clampi((int64_t)(x[i] * inv_cell_));
            const int64_t cy = clampi((int64_t)(y[i] * inv_cell_));
            cell_of_[i] = cx * side_ + cy;
            counts_[cell_of_[i] + 1]++;
        }
        for (size_t c = 1; c < counts_.size(); ++c)
            counts_[c] += counts_[c - 1];
        fill_ = counts_;  // running write cursors
        for (int64_t i = 0; i < n; ++i)
            order_[fill_[cell_of_[i]]++] = i;
    }

    int64_t side() const { return side_; }
    int64_t cell_of(int64_t i) const { return cell_of_[i]; }
    // members of cell c: order_[counts_[c] .. counts_[c+1])
    const int64_t* begin_of(int64_t c) const { return order_.data() + counts_[c]; }
    const int64_t* end_of(int64_t c) const { return order_.data() + counts_[c + 1]; }

  private:
    int64_t clampi(int64_t v) const {
        return v < 0 ? 0 : (v >= side_ ? side_ - 1 : v);
    }
    int64_t side_ = 0;
    double inv_cell_ = 0.0;
    std::vector<int64_t> counts_, fill_, order_, cell_of_;
};

}  // namespace

extern "C" {

// Seeded lattice+shuffle initializer, bit-identical to the reference's
// (part1/main.cpp:31-59) via the same libstdc++ facilities. SoA output.
void ppsim_init_particles(double* x, double* y, double* vx, double* vy,
                          int64_t n, double size, int seed) {
    std::mt19937 gen(seed);
    const int sx = (int)std::ceil(std::sqrt((double)n));
    const int sy = (int)((n + sx - 1) / sx);

    std::vector<int64_t> shuffle(n);
    for (int64_t i = 0; i < n; ++i)
        shuffle[i] = i;

    for (int64_t i = 0; i < n; ++i) {
        std::uniform_int_distribution<int> pick(0, (int)(n - i - 1));
        const int j = pick(gen);
        const int64_t k = shuffle[j];
        shuffle[j] = shuffle[n - i - 1];

        x[i] = size * (1.0 + (double)(k % sx)) / (1 + sx);
        y[i] = size * (1.0 + (double)(k / sx)) / (1 + sy);

        std::uniform_real_distribution<float> vdist(-1.0, 1.0);
        vx[i] = vdist(gen);
        vy[i] = vdist(gen);
    }
}

// Brute-force O(N^2) engine: nsteps of force+integrate (the trust anchor,
// mirroring part1/reference.cpp:52-65 behaviorally).
void ppsim_run_oracle(double* x, double* y, double* vx, double* vy, int64_t n,
                      double size, int64_t nsteps, double cutoff, double min_r,
                      double mass, double dt) {
    const Params p{cutoff, min_r, mass, dt};
    std::vector<double> ax(n), ay(n);
    for (int64_t s = 0; s < nsteps; ++s) {
        for (int64_t i = 0; i < n; ++i) {
            double axi = 0, ayi = 0;
            for (int64_t j = 0; j < n; ++j)
                accumulate_force(x[i], y[i], x[j], y[j], p, axi, ayi);
            ax[i] = axi;
            ay[i] = ayi;
        }
        for (int64_t i = 0; i < n; ++i)
            integrate(x[i], y[i], vx[i], vy[i], ax[i], ay[i], dt, size);
    }
}

// Cell-list O(N) engine: counting-sort rebin each step, 3x3 stencil forces.
void ppsim_run_cells(double* x, double* y, double* vx, double* vy, int64_t n,
                     double size, int64_t nsteps, double cutoff, double min_r,
                     double mass, double dt) {
    const Params p{cutoff, min_r, mass, dt};
    CellList cells(size, cutoff);
    const int64_t side = cells.side();
    std::vector<double> ax(n), ay(n);

    for (int64_t s = 0; s < nsteps; ++s) {
        cells.build(x, y, n);
        for (int64_t i = 0; i < n; ++i) {
            double axi = 0, ayi = 0;
            const int64_t c = cells.cell_of(i);
            const int64_t cx = c / side, cy = c % side;
            for (int64_t dx = -1; dx <= 1; ++dx) {
                const int64_t nx = cx + dx;
                if (nx < 0 || nx >= side)
                    continue;
                for (int64_t dy = -1; dy <= 1; ++dy) {
                    const int64_t ny = cy + dy;
                    if (ny < 0 || ny >= side)
                        continue;
                    const int64_t nc = nx * side + ny;
                    for (const int64_t* it = cells.begin_of(nc);
                         it != cells.end_of(nc); ++it)
                        accumulate_force(x[i], y[i], x[*it], y[*it], p, axi, ayi);
                }
            }
            ax[i] = axi;
            ay[i] = ayi;
        }
        for (int64_t i = 0; i < n; ++i)
            integrate(x[i], y[i], vx[i], vy[i], ax[i], ay[i], dt, size);
    }
}

// Interacting-pair distance statistics of ONE saved frame (the checker's
// inner loop). The trajectory checker mirrors the CS267 course tool's
// absmin/absavg gate (SURVEY.md §4; the reference exposes it through the
// `-o -s 42` save path, part1/job-serial:9-16); this native pass exists so
// multi-million-particle 3D frames can be checker-gated in seconds on the
// one-core host instead of hours in numpy. Counts each unordered pair once
// (same-cell triangle + half stencil); absmin/absavg are invariant to the
// single/double counting choice. `pos` is the (n, dim) C-order frame;
// out = {dmin (1e30 if no pair), dsum, dcount}.
void ppsim_frame_stats(const double* pos, int64_t n, int dim, double cutoff,
                       double* out) {
    double dmin = 1e30, dsum = 0.0;
    int64_t dcount = 0;
    if (n > 0 && (dim == 2 || dim == 3)) {
        double side = 1e-9;
        for (int64_t i = 0; i < n * dim; ++i)
            side = std::fmax(side, pos[i]);
        // Cell side >= cutoff keeps all sub-cutoff pairs inside the 3^dim
        // stencil; doubling it caps the dense cell table (memory guard for
        // corrupted/exploded frames with huge coordinates).
        double cell = cutoff;
        auto ncells_for = [&](double c) {
            const double per = std::ceil(side / c);
            double total = 1;
            for (int d = 0; d < dim; ++d)
                total *= per;
            return total;
        };
        while (ncells_for(cell) > 2.7e8)
            cell *= 2.0;
        const int64_t side_c = std::max<int64_t>(1, (int64_t)std::ceil(side / cell));
        const double inv_cell = 1.0 / cell;
        auto clampi = [&](int64_t v) {
            return v < 0 ? 0 : (v >= side_c ? side_c - 1 : v);
        };

        int64_t ncells = 1;
        for (int d = 0; d < dim; ++d)
            ncells *= side_c;
        std::vector<int64_t> cell_of(n), counts(ncells + 1, 0), order(n);
        for (int64_t i = 0; i < n; ++i) {
            int64_t c = 0;
            for (int d = 0; d < dim; ++d)
                c = c * side_c + clampi((int64_t)(pos[i * dim + d] * inv_cell));
            cell_of[i] = c;
            counts[c + 1]++;
        }
        for (int64_t c = 1; c <= ncells; ++c)
            counts[c] += counts[c - 1];
        std::vector<int64_t> fill(counts.begin(), counts.end() - 1);
        for (int64_t i = 0; i < n; ++i)
            order[fill[cell_of[i]]++] = i;
        // Gather positions into cell order once: the pair loops then stream
        // contiguous memory instead of cache-missing through `order` (~2x
        // on 20M-particle frames).
        std::vector<double> spos(n * dim);
        for (int64_t r = 0; r < n; ++r)
            for (int d = 0; d < dim; ++d)
                spos[r * dim + d] = pos[order[r] * dim + d];

        const double c2 = cutoff * cutoff;
        auto pair = [&](int64_t i, int64_t j) {
            double r2 = 0;
            for (int d = 0; d < dim; ++d) {
                const double dd = spos[i * dim + d] - spos[j * dim + d];
                r2 += dd * dd;
            }
            if (r2 < c2) {
                const double r = std::sqrt(r2);
                dmin = std::fmin(dmin, r);
                dsum += r;
                dcount++;
            }
        };
        // Lexicographically-positive half stencils (each unordered cell
        // pair visited once).
        static const int HALF2[4][3] = {{0, 1, 0}, {1, -1, 0}, {1, 0, 0}, {1, 1, 0}};
        static const int HALF3[13][3] = {
            {0, 0, 1}, {0, 1, -1}, {0, 1, 0}, {0, 1, 1},
            {1, -1, -1}, {1, -1, 0}, {1, -1, 1}, {1, 0, -1}, {1, 0, 0},
            {1, 0, 1}, {1, 1, -1}, {1, 1, 0}, {1, 1, 1}};
        const int(*half)[3] = dim == 2 ? HALF2 : HALF3;
        const int nhalf = dim == 2 ? 4 : 13;

        for (int64_t c = 0; c < ncells; ++c) {
            const int64_t b = counts[c], e = counts[c + 1];
            if (b == e)
                continue;
            for (int64_t a = b; a < e; ++a)  // same-cell triangle
                for (int64_t bb = a + 1; bb < e; ++bb)
                    pair(a, bb);
            int64_t idx[3];
            int64_t rem = c;
            for (int d = dim - 1; d >= 0; --d) {
                idx[d] = rem % side_c;
                rem /= side_c;
            }
            for (int o = 0; o < nhalf; ++o) {
                int64_t nc = 0;
                bool ok = true;
                for (int d = 0; d < dim; ++d) {
                    const int64_t v = idx[d] + half[o][d];
                    if (v < 0 || v >= side_c) {
                        ok = false;
                        break;
                    }
                    nc = nc * side_c + v;
                }
                if (!ok)
                    continue;
                for (int64_t a = b; a < e; ++a)
                    for (int64_t bb = counts[nc]; bb < counts[nc + 1]; ++bb)
                        pair(a, bb);
            }
        }
    }
    out[0] = dmin;
    out[1] = dsum;
    out[2] = (double)dcount;
}

}  // extern "C"
