// fused_simulate_network: a whole river-network simulation in one launch, and
// fused_simulate_network_batched: M such simulations (ensemble members) in one
// launch, one thread block per member.
//
// Replaces flowsim_tpu/ops/pallas/fused_network.py (_kernel_network via
// _build_call_network / fused_simulate_network, and _kernel_network_batched
// via _build_call_network_batched / fused_simulate_network_batched, with
// their table path: fused_network.py:419, :459-467 and :1471, :1556-1580 ->
// fused_newton._section_df_table_rows, fused_newton.py:341): for each
// time level — pad re-sync, gate-controller update, previous-level state —
// a while-Newton over the whole network: every branch's closures, cell
// residuals and Jacobian with equal-stage rows at its junction ends, one PCR
// solve per branch for 1 + its junction couplings right-hand sides, the
// junction residuals, the J x J Schur system and its solve, then every
// branch's increment.  The loop ends on the PRE-update residual norm with
// that iteration's update still applied.
//
// It computes what the stacked engine of ops/network.py computes (that engine
// with linear_solver="pcr" is its plain version): every branch edge-padded to
// the longest length Nmax, pad cells carrying delta-copy equations
// (dh_{i+1} = dh_i, dQ_{i+1} = dQ_i, no residual), so the padded end Nmax-1
// mirrors each branch's real end and external rows and junction couplings sit
// at node 0 and Nmax-1 of every branch.  Pads are re-synced to their branch's
// end at every level start.
//
// What bounds it on an H100: latency, as for the single reach (fused_newton.cu):
// the iterations are sequential and each is a chain of barrier-separated
// steps — closures, assembly with the residual reduction, ceil(log2 Nmax) PCR
// sweeps, back-substitution, Schur assembly, the J x J solve, update.  So:
//
//  * ONE thread block per network (the CLUSTER build: one cluster); slot
//    s = b * Nmax + i is (branch, node), and a thread owns the same slots in
//    every step and every level;
//  * the state is float64: per slot h and Q, the level-start h, Q, A, Se and
//    Q2A, the lateral-inflow cell averages of the level, and two
//    component-major PCR buffers of 12 + 2 RHS doubles a slot (RHS = 1 + the
//    most couplings of a branch: 2 or 3); the second buffer is the
//    neighbour-exchange area of the closures during assembly and receives the
//    solution columns after the back-substitution.  44 doubles a slot at
//    RHS = 3: about 650 slots fit the 227 KB of shared memory of a block
//    together with the junction block (J (J + 6) doubles) and the gate state
//    (4 B).  A network that does not fit keeps its slot arrays in a scratch
//    of device memory (the SCRATCH build below), its junction block and gate
//    state in shared memory;
//  * the PCR is pcr_common.cuh's sweep on each branch's Nmax segment of the
//    buffers (neighbours outside the segment read as identity rows), so every
//    branch takes the same ceil(log2 Nmax) sweeps, one barrier each;
//  * junction rows: G_j and dQ_out/dY go to threads that own no slot when
//    there are J of them (else to threads 0..J-1), so they do not lengthen an
//    end slot's thread.  The Schur row of junction j is formed from the end
//    values of the solution columns in the stacked engine's order (branches
//    in order, downstream end first) and solved by Gauss-Jordan elimination
//    with partial pivoting (the plain version's torch.linalg.solve is an LU
//    with partial pivoting: the two agree to rounding).  J = 1: every thread
//    forms the 1 x 1 system itself and reads its own dY, with no barrier;
//    J <= 32: lane j of warp 0 forms row j and warp 0 solves, one barrier;
//    J > 32: every thread forms rows, a barrier, warp 0 solves, a barrier;
//  * the residual norm is one block reduction over the real cells, the end
//    rows and the junction rows only (pads are not added, not multiplied by
//    zero); every thread reads the same sum, so the Newton while exits
//    uniformly;
//  * blockIdx.x is the member (in the SCRATCH build, the first of the
//    block's members): each member has its own geometry, initial
//    state, boundary series and parameters, storage blocks and tables,
//    lateral inflow and initial junction stages; the branch layout, the
//    boundary kinds and the junction configuration are shared.  A member's
//    per-level counts are those of its single run, and a member that diverges
//    holds up no other.
//
// Builds, which run when, and why (chosen by the C entry):
//  * the LATENCY build, for a network whose slots fit the block (slots <=
//    256: the tributary's 183, the 15-branch basin's 195) and a batch the
//    card holds at once in it (single networks, small ensembles): a thread
//    owns one slot for the whole run and keeps its geometry, branch and node
//    index, previous-level state and this iteration's closures in registers,
//    as kernel 1 does; nothing is reloaded from the geometry rows inside the
//    Newton loop and the end rows reuse the iteration's closures;
//  * the LOOP build, for a network with more slots than threads (the basin at
//    levels=5: 403): the threads loop over the slots, the geometry is read
//    from device memory (L1) where it is needed;
//  * the RESIDENCY build, for a network whose slots fit the block and a
//    batch larger than the card holds at once in the latency build (one
//    block an SM: 204-255 registers): the latency build's form under
//    __launch_bounds__(threads, 2), which caps the registers (and spills the
//    rest) so that two blocks share an SM, twice the members in flight.
//    Three blocks an SM ran no faster, and the loop form under the same cap
//    slower (PERF.md); a network with more slots than threads has no
//    residency build;
//  * the SCRATCH build, for a network whose slot arrays do not fit one
//    block's shared memory (the basin at levels >= 6, the tributary on the
//    flagship refined to 250 m or finer, up to J = 120 junctions and
//    branches of 8192 nodes): the loop build — its threads, its slot-to-thread
//    assignment, its operations in their order — with the slot arrays in a
//    scratch of device memory the wrapper allocates, (2 C + 8) doubles a
//    slot, read through L1 and L2.  The grid is persistent: min(members,
//    resident blocks) blocks, one scratch each, block k running members k,
//    k + grid, ... one after another, so the scratch grows with the card, not
//    with the batch; a member's results do not depend on its block.
//  * the CLUSTER build, for a network whose slot arrays do not fit one block's
//    shared memory but fit a thread-block cluster's (2-16 blocks on
//    neighbouring SMs; every network the scratch build would otherwise take up
//    to about 11 600 slots): block rank r of the cluster owns the contiguous
//    slots r * per .. r * per + per - 1 (slot order unchanged, a branch may
//    span ranks) and keeps their slot arrays in its own shared memory, in the
//    layout of the other builds with per slots.  A slot of another rank — the
//    cell (i, i+1) at a rank's edge, the sweep's partners at i -/+ stride, the
//    end slots the junction and Schur rows read — is read or written there
//    through distributed shared memory (DSMEM); the junction block and the
//    gate state live in rank 0, whose threads run the junction rows, the Schur
//    rows and the J x J solve.  Every barrier that publishes slot data is a
//    cluster barrier; the norm is each rank's block_sum, summed in rank order
//    by every thread (cluster_sum), so the while exits uniformly.  A rank runs
//    the latency form (one slot a thread, per <= 256: the fewest blocks that
//    give it) or, at 16 blocks, the loop form; the two-blocks-an-SM form (the
//    residency build's 192 threads) is a test hook for batches.  Members run
//    on a persistent grid of clusters, as in the SCRATCH build.  Only the
//    norm's summation order differs from the other builds: every other field
//    has their bits, the norm agrees to rounding.
//  * the BRACKET build (table library only), for a network with table
//    branches where the RESIDENCY build would run (a batch past one wave of
//    the latency build: the surveyed network ensembles): the residency
//    build's form, two blocks an SM, with each table slot's bracket index
//    and its 14 bracket values cached in shared memory after the junction
//    block (section_state_cached: the tables are re-read only when the depth
//    leaves the bracket; the same values and expressions), and the sweeps
//    with the carried inverse and the slot's own rows in registers
//    (pcr::sweep_node_at_carried, the inverse in D's place, so the buffers
//    keep their size); its level-start state lies in the assembly buffer
//    (components 7-11, free from a level's start to its first assembly) and
//    the end rows read the section the closures left beside the exchange
//    area, so no Sec is held in registers: 388 B a slot at RHS = 2, two
//    blocks an SM (three ran slower: 96 registers).  The residency build
//    read two rows of seven tables through L2 at every closure and inverted
//    every partner's D twice a sweep.  The same bits.
//  * the LEAN build (table library only), for a network with table branches
//    where the LATENCY build would run (one network, batches the card holds
//    at once) and the LEAN build holds the batch at once too: the BRACKET
//    form under the LATENCY build's launch bound (255 registers), and one
//    closure pass a Newton iteration, none between levels: a level's
//    previous-level closures are those of its first iteration (the same
//    state, no update between them), which that iteration's closures and
//    cells keep in registers, so a level has no closure pass and no
//    barrier before its Newton loop and no level-start array; a trapezoid
//    slot that is not compound evaluates its section without the compound
//    code (section_state_plain).  The LEAN_SIDE build, where the network
//    has up to 192 slots, 16 branches and 32 junctions (lean_side) and each
//    member has an SM of its own, is the LEAN build with two warps beyond
//    the slots' (the side warps) that take the external end rows and the
//    junction rows while the slots' warps assemble their cells.  The probe
//    split the surveyed mixed network's assembly and found most of it to
//    be the wait at the closures' barrier:
//    the tributary's trapezoid slots ran the compound code (flood-plain
//    subsections and a compound conveyance, computed and discarded for a
//    plain trapezoid) while every table slot waited; the end and junction
//    rows came after the cells in their warps (PERF.md).  The same bits.
//  Every build does the same operations in the same order and gives the
//  same bits; the build id of the C entry is a test hook for chip_smoke.py.
//  The probe build (PROBE, reach_common.cuh) of the loop, latency, scratch,
//  cluster, bracket and lean forms sums the cycles of each phase of an
//  iteration, and splits the assembly (AssemblyProbe).
//
// Table branches (irregular sections; the TABLE builds).  A branch's geometry
// is a trapezoid (closed forms) or per-node lookup tables of M depth samples
// (reach_common.cuh, TabGeo: section_state(const TabGeo&) reads two rows of
// each of the seven tables, the bracket formed as the plain engine forms it).
// A network with a table branch takes a TABLE build, in which each slot
// evaluates its own branch's closure (tab_branch: the branch's index among
// the table branches, -1 for a trapezoid), so trapezoid and table branches
// mix freely.  The tables stay in device memory in float64, [T, 7, Nmax, M] for
// the T table branches (A, P, T, dR/dA, K, n_eq, dK/dA), edge-padded along
// the node axis so that a pad node reads its branch's last node, and are
// read through L2: one copy for the launch, shared by every member (a batch
// cannot override a table branch's geometry).  A table branch's geometry
// rows hold the bed level (G_ZBED), the table span (G_BMAIN), the bed slope
// and the curvature.  The TPU kernel evaluates both closures on every
// sublane with benign padding rows and selects, and gathers each bracket by
// one-hot masks over the table in VMEM, in double-single arithmetic; here a
// slot evaluates one closure and reads its bracket by index.  The builds
// without TABLE compile as before: the table code is under if constexpr and
// the table arguments follow every earlier one.
// This source is built twice, into two libraries compiled side by side: the
// trapezoid builds, and with -DFLOWSIM_NETWORK_TABLE=1 the TABLE builds
// (ops/cuda/build.py VARIANTS); each library's C entry holds its own set.
//
// Dropped from the TPU kernel, which needs them only for the TPU: double-single
// (df32) arithmetic and the f32 Jacobian (the card has FP64), one-hot sublane
// scatters and gathers for the Schur assembly, the level streamer, the
// data-derived zeros, the VMEM member cap (and its cap on the table
// resolution M: device memory bounds M here), the VMEM budget of a network's
// working set (fused_network.py:1286-1315, :2280-2299: the SCRATCH build
// takes what shared memory does not hold), the benign table blocks.
//
// External ends take every kind kernel 1 takes (boundary_row / storage_row of
// reach_common.cuh: hydrographs, fixed and normal depth, polynomial and
// blended ratings, the gated controller downstream, lumped storage at either
// end or both, its outflow rating of any kind but gated_blend).  Junction
// ratings: polynomial, blended_poly, poly_n, power and table, with
// ops/rating_curve.py's formulas (central difference for the blended and
// table slopes, analytic otherwise); a junction's Q and a storage's outflow
// use one function for the kinds beyond the quadratics, reach_common.cuh's
// rating_discharge_n.
//
// Float64 throughout; the expressions and their association are the plain
// engine's, built with --fmad=false.
//
// C interface (ctypes): launches on the given stream, allocates nothing (the
// SCRATCH build's scratch is the caller's), does not synchronise, returns
// cudaGetLastError().
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <type_traits>

#include "pcr_common.cuh"
#include "reach_common.cuh"

namespace {

// per-branch ints [B, BI_COUNT]; a junction end holds its id, an external
// end -1
enum { BI_N, BI_US_J, BI_DS_J, BI_US_KIND, BI_DS_KIND, BI_RC_KIND, BI_URC_KIND,
       BI_US_SFLAGS, BI_DS_SFLAGS, BI_US_NV, BI_US_NA, BI_DS_NV, BI_DS_NA, BI_US_NR, BI_DS_NR, BI_TAB_OFF,
       BI_COUNT };

// a table branch's seven tables [TAB_COUNT, Nmax, M]: the four of TS_*, then
// K, n_eq and dK/dA; its geometry rows keep the table span in the G_BMAIN row
enum { TAB_K = TS_COUNT, TAB_NEQ, TAB_DK, TAB_COUNT };
#ifndef FLOWSIM_NETWORK_TABLE
#define FLOWSIM_NETWORK_TABLE 0
#endif
// the builds this library holds: those of networks with table branches, or
// of trapezoid networks
constexpr bool LIB_TABLE = FLOWSIM_NETWORK_TABLE != 0;

// per-junction parameters [J, JP_COUNT]: reservoir area, rating kind (JR_*),
// stage shift, pivot, buffer, finite-difference step, the low and high
// quadratics (power: a, b in C0, C1), and the count and offset of poly_n
// coefficients (ascending) or of a table (stages then discharges) in jtab
enum { JP_AREA, JP_KIND, JP_SHIFT, JP_PIVOT, JP_BUFFER, JP_FD, JP_C0, JP_C1, JP_C2,
       JP_H0, JP_H1, JP_H2, JP_NCOEF, JP_OFF, JP_COUNT };
enum { JR_NONE = -1, JR_POLY = RC_POLY, JR_BLEND = RC_BLEND, JR_POLY_N = RC_POLY_N, JR_POWER = RC_POWER,
       JR_TABLE = RC_TABLE };

constexpr int MAX_THREADS = 256;
constexpr int SIDE_WARPS = 2;   // the LEAN build's side warps: external end rows, junction rows
constexpr int MAX_JUNCTION_ENDS = 8;   // a longer list is scanned from the branch table
constexpr int STATE_DOUBLES_PER_SLOT = 8;   // h, Q, hp, Qp, Ap, Sep, Q2Ap, qavg

__host__ __device__ constexpr int comp(int rhs) { return 12 + 2 * rhs; }

// the slot arrays of one network: two PCR buffers and the state
__host__ __device__ inline size_t slot_doubles(int slots, int rhs) {
    return (size_t)slots * (2 * comp(rhs) + STATE_DOUBLES_PER_SLOT);
}

// the junction block (J stages and five columns, the J x J Schur matrix) and
// the gate state (4 a branch): in shared memory in every build
__host__ __device__ inline size_t junction_doubles(int B, int J) {
    return (size_t)J * (J + 6) + 4 * (size_t)B;
}

__host__ __device__ inline size_t smem_doubles(int slots, int B, int J, int rhs) {
    return slot_doubles(slots, rhs) + junction_doubles(B, J);
}

// -- the CLUSTER build's cluster ----------------------------------------------

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 16;     // blocks of a cluster (above 8: non-portable)
constexpr int PAIR_THREADS = 192;   // the two-blocks-an-SM form's block
constexpr int CLUSTER_PAIR = 256;   // the flag of that form in the C entry's `cluster`
// the BRACKET build's blocks an SM in its launch bound: two beat three on
// an H100 (PERF.md)
constexpr int BRACKET_MINB = 2;

// slots of each rank of a cluster of `blocks` blocks (the last may hold fewer)
__host__ __device__ inline int rank_slots(int slots, int blocks) { return (slots + blocks - 1) / blocks; }

// this block's rank in its cluster, and the cluster's blocks (0 and 1 outside
// the CLUSTER build)
template <bool CLUSTER>
__device__ __forceinline__ int cluster_rank() {
    if constexpr (CLUSTER) return (int)cg::this_cluster().block_rank();
    else return 0;
}
template <bool CLUSTER>
__device__ __forceinline__ int cluster_blocks() {
    if constexpr (CLUSTER) return (int)cg::this_cluster().num_blocks();
    else return 1;
}

// The CLUSTER build's slots of this block's rank, lo .. lo + cnt - 1, in
// slot arrays of leading dimension lds (nothing outside the CLUSTER build)
template <bool CLUSTER>
struct Ranks {
    int lo, cnt, lds;
};
template <>
struct Ranks<false> {};

template <bool CLUSTER>
__device__ __forceinline__ Ranks<CLUSTER> ranks_of(int lo, int cnt, int lds) {
    if constexpr (CLUSTER) return Ranks<CLUSTER>{lo, cnt, lds};
    else return Ranks<CLUSTER>{};
}

// a slot's index in the network (GS) of its index in this rank (s), and
// back (LS): the same outside the CLUSTER build
template <bool CLUSTER>
__device__ __forceinline__ int global_slot(Ranks<CLUSTER> r, int s) {
    if constexpr (CLUSTER) return r.lo + s;
    else return s;
}
template <bool CLUSTER>
__device__ __forceinline__ int local_slot(Ranks<CLUSTER> r, int g) {
    if constexpr (CLUSTER) return g - r.lo;
    else return g;
}

// Another slot's element x of a slot array, x counted from this rank's first
// slot: in the CLUSTER build a slot beyond the rank's range lies at the same
// offset in its own rank's shared memory (every rank has the same layout),
// reached through distributed shared memory.  The kernel calls these in the
// CLUSTER build only (its AT / ATC macros).
template <bool CLUSTER, class T>
__device__ __forceinline__ T& slot_at(Ranks<CLUSTER> r, T* arr, int x) {
    if constexpr (CLUSTER) {
        if (x < 0 || x >= r.cnt) {
            const int g = r.lo + x, q = g / r.lds;
            return *cg::this_cluster().map_shared_rank(arr + (g - q * r.lds), q);
        }
    }
    return arr[x];
}
// the same for component c of a PCR buffer of leading dimension lds
template <bool CLUSTER, class T>
__device__ __forceinline__ T& slot_at(Ranks<CLUSTER> r, T* buf, int c, int lds, int x) {
    if constexpr (CLUSTER) {
        if (x < 0 || x >= r.cnt) {
            const int g = r.lo + x, q = g / lds;
            return *cg::this_cluster().map_shared_rank(buf + (c * lds + (g - q * lds)), q);
        }
    }
    return buf[c * lds + x];
}

// The CLUSTER build's residual norm: each rank's block_sum, published in its
// shared memory; the cluster barrier that follows also publishes the
// assembled system; then every thread adds the ranks' sums in rank order, so
// every thread of the cluster holds the same value.  parity alternates with
// the iteration, as block_sum's warp_part does, so that a slow reader never
// sees the next iteration's sum.
__device__ __forceinline__ double cluster_sum(double v, double* warp_part, int parity) {
    __shared__ double rank_part[2];
    cg::cluster_group cluster = cg::this_cluster();
    const double t = block_sum(v, warp_part);
    if (threadIdx.x == 0) rank_part[parity] = t;
    cluster.sync();
    double total = 0.0;
    for (unsigned q = 0; q < cluster.num_blocks(); ++q) total += *cluster.map_shared_rank(&rank_part[parity], q);
    return total;
}

// -- ops/rating_curve.py at a junction ---------------------------------------

// Q(Y) of a junction's release rating; the kinds beyond the quadratics by
// reach_common.cuh's rating_discharge_n, the function the storage rows call
__device__ double junction_q(const double* __restrict__ jp, const double* __restrict__ jtab, double Y) {
    const int kind = (int)jp[JP_KIND];
    if (kind == JR_POLY) {
        const double x = Y + jp[JP_SHIFT];
        return jp[JP_C0] * x * x + jp[JP_C1] * x + jp[JP_C2];
    }
    if (kind == JR_BLEND) {
        Rating r{jp[JP_C0], jp[JP_C1], jp[JP_C2], jp[JP_H0], jp[JP_H1], jp[JP_H2], 0.0, jp[JP_PIVOT],
                 jp[JP_BUFFER], jp[JP_FD], 0.0, RC_BLEND};
        return rating_q(r, Y, 0.0);
    }
    if (kind == JR_NONE) return 0.0;
    return rating_discharge_n(kind, jp[JP_C0], jp[JP_C1], jp[JP_SHIFT], jtab + (int)jp[JP_OFF], (int)jp[JP_NCOEF],
                              Y);
}

__device__ double junction_dq(const double* __restrict__ jp, const double* __restrict__ jtab, double Y) {
    const int kind = (int)jp[JP_KIND];
    if (kind == JR_POLY) {
        const double x = Y + jp[JP_SHIFT];
        return jp[JP_C0] * 2.0 * x + jp[JP_C1];
    }
    if (kind == JR_POLY_N) {   // the derivative's ascending coefficients c[j+1] * (j+1)
        const int n = (int)jp[JP_NCOEF];
        const double* c = jtab + (int)jp[JP_OFF];
        if (n < 2) return 0.0;
        const double x = Y + jp[JP_SHIFT];
        double out = c[n - 1] * (double)(n - 1);
        for (int j = n - 3; j >= 0; --j) out = out * x + c[j + 1] * (double)(j + 1);
        return out;
    }
    if (kind == JR_POWER) {
        const double x = Y + jp[JP_SHIFT];
        return jp[JP_C0] * jp[JP_C1] * pow(x, jp[JP_C1] - 1.0);
    }
    if (kind == JR_BLEND || kind == JR_TABLE) {
        const double d = jp[JP_FD];
        return (junction_q(jp, jtab, Y + d) - junction_q(jp, jtab, Y - d)) / (2.0 * d);
    }
    return 0.0;
}

// Gauss-Jordan elimination with partial pivoting of the J x J system
// M x = rhs (shared memory, row-major) by one warp; every lane calls it and
// x goes to x.  Lane 0 picks the pivot of column c (the first row from c on
// of largest |entry|) and swaps the rows; lane r reduces row r.  Each row is
// reduced in groups of four entries, all loads of a group before its stores,
// so that the loads overlap (row c is never written in the step).
__device__ void warp_gauss_jordan(double* M, double* rhs, double* x, int J, int lane) {
    for (int c = 0; c < J; ++c) {
        if (lane == 0) {
            int p = c;
            double best = fabs(M[(size_t)c * J + c]);
            for (int r = c + 1; r < J; ++r) {
                const double v = fabs(M[(size_t)r * J + c]);
                if (v > best) { best = v; p = r; }
            }
            if (p != c) {
                for (int q = 0; q < J; ++q) {
                    const double t = M[(size_t)c * J + q];
                    M[(size_t)c * J + q] = M[(size_t)p * J + q];
                    M[(size_t)p * J + q] = t;
                }
                const double t = rhs[c]; rhs[c] = rhs[p]; rhs[p] = t;
            }
        }
        __syncwarp();
        const double piv = M[(size_t)c * J + c];
        const double* mc = M + (size_t)c * J;
        for (int r = lane; r < J; r += 32) {
            if (r == c) continue;
            double* mr = M + (size_t)r * J;
            const double f = mr[c] / piv;
            int q = c;
            for (; q + 4 <= J; q += 4) {
                const double c0 = mc[q], c1 = mc[q + 1], c2 = mc[q + 2], c3 = mc[q + 3];
                const double r0 = mr[q], r1 = mr[q + 1], r2 = mr[q + 2], r3 = mr[q + 3];
                mr[q] = r0 - f * c0; mr[q + 1] = r1 - f * c1; mr[q + 2] = r2 - f * c2; mr[q + 3] = r3 - f * c3;
            }
            for (; q < J; ++q) mr[q] -= f * mc[q];
            rhs[r] -= f * rhs[c];
        }
        __syncwarp();
    }
    for (int r = lane; r < J; r += 32) x[r] = rhs[r] / M[(size_t)r * J + r];
}

// One node's tables: row is its row of the branch's first table, nm = Nmax *
// M doubles between two tables; dgrid = depth_max / (M - 1) as the plain
// engine forms it, jmax = M - 2.
__device__ __forceinline__ TabGeo tab_geo(const double* row, size_t nm, double z, double curv, double dgrid,
                                          double jmax) {
    TabGeo t;
    t.ts = row;
    t.k = row + TAB_K * nm;
    t.neq = row + TAB_NEQ * nm;
    t.dk = row + TAB_DK * nm;
    t.nm = nm;
    t.z = z; t.curv = curv; t.dgrid = dgrid; t.jmax = jmax;
    return t;
}

// A slot's geometry in a TABLE build: its branch's geometry rows, and for a
// slot of a table branch (row not null) its node's tables.  Both kinds keep
// the curvature in the same row, which is all energy_slope reads.
struct SlotGeo {
    Geo g;
    const double* row;
    size_t nm;
    double dgrid, jmax, curv;
};

__device__ __forceinline__ Sec section_state(const SlotGeo& s, double depth) {
    if (s.row != nullptr) return section_state(tab_geo(s.row, s.nm, s.g.z, s.curv, s.dgrid, s.jmax), depth);
    return section_state(s.g, depth);
}

// A slot's section: in the BRACKET build a table slot's bracket cached in
// shared memory at cache[c * ld + x], its index at cidx[x]
// (section_state_cached: the same values and expressions), and in the LEAN
// build a trapezoid slot that is not compound by section_state_plain; every
// other slot, and every other build, section_state.
template <bool BRACKET, bool LEAN = false, class GEO>
__device__ __forceinline__ Sec slot_section(const GEO& g, double depth, double* cache, int* cidx, int ld, int x) {
    if constexpr (BRACKET) {
        if (g.row != nullptr)
            return section_state_cached(tab_geo(g.row, g.nm, g.g.z, g.curv, g.dgrid, g.jmax), depth, cache, cidx,
                                        ld, x);
    }
    if constexpr (LEAN) {
        if (!g.g.compound) return section_state_plain(g.g, depth);
    }
    return section_state(g, depth);
}

// The BRACKET build's dynamic shared memory: the two PCR buffers, h and Q a
// slot (its level-start state lies in the assembly buffer), the junction
// block, then each slot's bracket, BK_COUNT doubles and an int.
__host__ __device__ inline size_t bracket_smem_bytes(int slots, int B, int J, int rhs) {
    return ((size_t)slots * (2 * comp(rhs) + 2) + junction_doubles(B, J)) * sizeof(double)
        + (size_t)slots * (BK_COUNT * sizeof(double) + sizeof(int));
}

// -- the LEAN build's side warps ----------------------------------------------

// Whether a network fits the LEAN build's side warps: they fit the block
// beside the slots' warps, and one warp's lanes hold the external ends (at
// most two a branch) and the junctions.
inline bool lean_side(int slots, int B, int J) {
    return ((slots + 31) / 32) * 32 + SIDE_WARPS * 32 <= MAX_THREADS && 2 * B <= 32 && J <= 32;
}

// The side warps' shared memory (LEAN): 32 external end residuals, then 32
// junctions' G.
template <bool ON>
__device__ __forceinline__ double* side_area() {
    if constexpr (ON) {
        __shared__ double a[2 * 32];
        return a;
    } else {
        return nullptr;
    }
}

// Named barrier 1 between the side warps (arrive, having written their
// results) and the slots' warps that read them (wait); count threads in all.
__device__ __forceinline__ void side_arrive(int count) {
    __threadfence_block();
    __syncwarp();
    asm volatile("bar.arrive 1, %0;" ::"r"(count) : "memory");
}
__device__ __forceinline__ void side_wait(int count) {
    __syncwarp();
    asm volatile("bar.sync 1, %0;" ::"r"(count) : "memory");
}

// -- the probe build's split of the assembly phase -----------------------------

// Parts of PH_ASSEMBLY, by the cycle at which the block's last thread
// reaches each point: the start of its first cell row (the wait: the
// probing thread reads the clock after the closures' barrier when its warp
// arrives there, not when the barrier releases, so a phase that ends at a
// barrier leaves the barrier's wait to the next), the end of its cell rows,
// of its end rows, of the junction rows, of the probe's own stamps (a warp
// maximum of each), then the norm (block_sum and its barrier); they add up
// to PH_ASSEMBLY.  Each thread stamps its own parts (in the loop forms, its
// first slot's start and its last slot's ends), so the split costs no
// barrier and changes no operation.
enum { AP_WAIT, AP_CELLS, AP_ENDS, AP_JUNCTIONS, AP_STAMPS, AP_NORM, AP_COUNT };

template <bool ON>
struct AssemblyProbe {
    __device__ __forceinline__ void begin(long long) {}
    __device__ __forceinline__ void start() {}
    __device__ __forceinline__ void mark(int) {}
    __device__ __forceinline__ void publish() {}
    __device__ __forceinline__ void account(bool, long long) {}
    __device__ __forceinline__ void write(bool, long long*) {}
};

template <>
struct AssemblyProbe<true> {
    // this thread's stamps at the start of its first cell row and after its
    // cell rows, end rows and junction rows; the probing thread's reading at
    // the closures' barrier
    long long ts = 0, t[3] = {}, t_begin = 0, cycles[AP_COUNT] = {};
    bool started = false;
    // per warp: the four stamps' maxima, then the warp's stamp after
    // publishing them
    static __device__ __forceinline__ long long* area() {
        __shared__ long long a[5][32];
        return &a[0][0];
    }
    __device__ __forceinline__ void begin(long long t0) {
        t_begin = t0;
        ts = t[0] = t[1] = t[2] = clock64();
        started = false;
    }
    __device__ __forceinline__ void start() {
        if (!started) ts = clock64();
        started = true;
    }
    __device__ __forceinline__ void mark(int part) { t[part] = clock64(); }
    // every thread of the block, after the junction rows
    __device__ __forceinline__ void publish() {
        long long v[4] = {ts, t[0], t[1], t[2]};
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) v[k] = max(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
        const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
        long long* a = area();
        if (lane == 0) {
#pragma unroll
            for (int k = 0; k < 4; ++k) a[k * 32 + warp] = v[k];
            a[4 * 32 + warp] = clock64();
        }
    }
    // the probing thread, after the norm's barrier (t_end its reading there)
    __device__ __forceinline__ void account(bool active, long long t_end) {
        if (!active) return;
        const long long* a = area();
        long long m[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            m[k] = a[k * 32];
            for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m[k] = max(m[k], a[k * 32 + w]);
        }
        // each part from the last thread's stamp before it to its own
        long long prev = t_begin;
#pragma unroll
        for (int k = 0; k < 5; ++k) {
            cycles[AP_WAIT + k] += m[k] - prev;
            prev = m[k];
        }
        cycles[AP_NORM] += t_end - prev;
    }
    __device__ __forceinline__ void write(bool active, long long* out) {
        if (!active) return;
#pragma unroll
        for (int k = 0; k < AP_COUNT; ++k) out[PH_COUNT + k] = cycles[k];
    }
};

__device__ __forceinline__ Geo load_geo(const double* __restrict__ geo, int n_max, int b, int i) {
    const double* r = geo + (size_t)b * G_ROWS * n_max + i;
    Geo g;
    g.z = r[G_ZBED * n_max];       g.b = r[G_BMAIN * n_max];
    g.m = r[G_MMAIN * n_max];      g.n = r[G_NMAIN * n_max];
    g.compound = r[G_COMPOUND * n_max] != 0.0;
    g.hbank = r[G_HBANK * n_max];  g.bl = r[G_BFPL * n_max];
    g.br = r[G_BFPR * n_max];      g.mfp = r[G_MFP * n_max];
    g.nl = r[G_NLEFT * n_max];     g.nr = r[G_NRIGHT * n_max];
    g.s0 = r[G_BEDSLOPE * n_max];  g.curv = r[G_CURV * n_max];
    return g;
}

// Builds (the header says which runs when).  LOOP: the block's threads loop
// over the slots.  LATENCY (slots <= threads): a thread owns one slot for the
// whole run.  RESIDENCY: the latency build's form under a launch bound that
// caps the registers so that two blocks fit an SM.  SCRATCH: the loop build
// with its slot arrays in device memory, on a persistent grid.  CLUSTER: one
// network over the blocks of a thread-block cluster, its slot arrays split
// by rank in their shared memory, on a persistent grid of clusters.
// BRACKET: the residency form with each table slot's bracket cached and
// carried sweeps.  LEAN: the BRACKET form under the LATENCY build's launch
// bound, one closure pass a Newton iteration and none between levels.
// LEAN_SIDE: the LEAN build with its side warps.
enum { LOOP_BUILD = 0, LATENCY_BUILD = 1, RESIDENCY_BUILD = 2, SCRATCH_BUILD = 3, CLUSTER_BUILD = 4,
       BRACKET_BUILD = 5, LEAN_BUILD = 6, LEAN_SIDE_BUILD = 7 };

// ONE: the latency build's one slot a thread (needs slots <= blockDim.x).
// PROBE: the probe build (reach_common.cuh, Probe).  TABLE: a network with
// table branches (each slot evaluates its branch's closure).  SCRATCH: the
// slot arrays in block blockIdx.x's part of scratch_all, and the block runs
// members blockIdx.x, blockIdx.x + gridDim.x, ... below n_members (the other
// builds run a grid of n_members blocks, one member each).  CLUSTER: the
// slots of this block's rank in its shared memory, the other ranks' through
// DSMEM, and the cluster runs members clusterIdx, clusterIdx + clusters, ...
// (ONE: one slot a thread of the rank's).  BRACKET (with ONE and TABLE): each
// table slot's bracket cached in shared memory after the junction block,
// and the sweeps with the carried inverse and the slot's own rows in
// registers (pcr::sweep_node_at_carried).  LEAN (with BRACKET, under the
// latency build's launch bound): a level's previous-level closures are its first Newton
// iteration's (the same state: no update between them), kept in registers
// as that iteration's closures and cells read them, so a level has no
// closure pass and no barrier of its own before the Newton loop and no
// level-start array; a trapezoid slot that is not compound takes
// section_state_plain.  SIDE (with LEAN): two warps beyond the slots' (the
// side warps) take the external end rows (lane e the network's e-th external end,
// branches in order, upstream end first) and the junction rows (lane j
// junction j) off the slots' warps while those assemble their cells; a
// slot's end residual and a junction's G reach the thread that adds them
// to the norm, in their old place, through shared memory and a named
// barrier, so the norm keeps its bits.
template <int RHS, int BLOCK, int MINB, bool ONE, bool PROBE, bool TABLE, bool SCRATCH, bool CLUSTER,
          bool BRACKET = false, bool LEAN = false, bool SIDE = false>
__global__ void __launch_bounds__(BLOCK, MINB)
fused_network_kernel(const double* __restrict__ geo_all,   // [M, B, 13, Nmax]
                     const double* __restrict__ h0_all,    // [M, B, Nmax]
                     const double* __restrict__ Q0_all,    // [M, B, Nmax]
                     const double* __restrict__ ser_all,   // [M, B, 2, nt]: us, ds target series
                     const double* __restrict__ par_all,   // [M, B, P_COUNT]
                     const double* __restrict__ qlat_all,  // [M, B, Nmax] / [M, nt, B, Nmax] / null
                     const double* __restrict__ stor_all,  // [M, B, 2, SP_COUNT]
                     const double* __restrict__ stab_all,  // [M, L] or shared [L]
                     long long stab_stride,                // doubles per member (0: shared)
                     const double* __restrict__ Y0_all,    // [M, J]
                     const int* __restrict__ bint,         // [B, BI_COUNT]
                     const double* __restrict__ jpar,      // [J, JP_COUNT]
                     const double* __restrict__ jtab,      // poly_n coefficients and tables
                     double* __restrict__ depth_all,       // [M, nt, B, Nmax]
                     double* __restrict__ flow_all,        // [M, nt, B, Nmax]
                     double* __restrict__ Y_all,           // [M, nt, J]
                     int* __restrict__ iters_all,          // [M, nt]
                     double* __restrict__ err_all,         // [M, nt]
                     int* __restrict__ conv_all,           // [M, nt]
                     double* stage_all,                    // [M, nt, B, 2]; NaN-filled
                     double* __restrict__ gate_all,        // [M, nt, B, 2]
                     long long* __restrict__ probe_out,    // [PH_COUNT + AP_COUNT] cycles (probe build)
                     int B, int n_max, int J, int nt, int max_iter, int sweeps, int qlat_mode,
                     const int* __restrict__ tab_branch,   // [B]: index among the table branches, or -1
                     const double* __restrict__ tab_all,   // [T, TAB_COUNT, Nmax, M], shared (TABLE)
                     int tab_m, int n_members,
                     double* scratch_all) {                // [grid, slot_doubles] (SCRATCH)
    static_assert(!SCRATCH || (!ONE && !CLUSTER), "the SCRATCH build is the loop form, in one block");
    static_assert(!BRACKET || (ONE && TABLE && !SCRATCH && !CLUSTER), "the BRACKET build is a TABLE latency form");
    static_assert(!LEAN || BRACKET, "the LEAN build is the BRACKET form");
    static_assert(!SIDE || LEAN, "the side warps are the LEAN build's");
    constexpr int C = comp(RHS);
    extern __shared__ double smem[];
    __shared__ double warp_part[2][32];
    const int rank = cluster_rank<CLUSTER>(), n_ranks = cluster_blocks<CLUSTER>();

// a barrier that publishes slot data: the whole cluster's in the CLUSTER build
#define NET_SYNC() do { if constexpr (CLUSTER) cg::this_cluster().sync(); else __syncthreads(); } while (0)
// the leading dimension of the slot arrays (LD); another slot's element of a
// slot array (AT; ATG by its index in the network) or component c of a PCR
// buffer (ATC), x counted from this rank's first slot; a slot's index in the
// network (GS) or in this rank (LS); the thread's index in the junction
// block's rank (TJ): the CLUSTER build's (rk: slot_at, global_slot,
// local_slot), and outside it the other builds' own expressions, unchanged
// (the same index through a call moved their registers and spills)
#define LD (CLUSTER ? lds : ld)
#define AT(arr, x) (*(CLUSTER ? &slot_at(rk, arr, x) : &(arr)[x]))
#define ATG(arr, g) (*(CLUSTER ? &slot_at(rk, arr, local_slot(rk, g)) : &(arr)[g]))
#define ATC(buf, c, x) (*(CLUSTER ? &slot_at(rk, buf, c, lds, x) : &(buf)[(c) * ld + (x)]))
#define GS(s) (CLUSTER ? global_slot(rk, s) : (s))
#define LS(g) (CLUSTER ? local_slot(rk, g) : (g))
#define TJ (CLUSTER ? tj : tid)

    // member blockIdx.x (CLUSTER: the cluster's index); the SCRATCH and
    // CLUSTER builds' persistent grid then runs the next members, one after
    // another
    size_t mem = CLUSTER ? blockIdx.x / n_ranks : blockIdx.x;
    do {
        const int ld = B * n_max;                      // slots
        // the slot arrays' slots: this rank's lo .. lo + cnt - 1 (CLUSTER), at
        // a leading dimension lds; every slot otherwise
        const int lds = CLUSTER ? rank_slots(ld, n_ranks) : ld;
        const int lo = CLUSTER ? rank * lds : 0;
        const int cnt = CLUSTER ? max(0, min(lds, ld - lo)) : ld;
        const Ranks<CLUSTER> rk = ranks_of<CLUSTER>(lo, cnt, lds);
        const double* geo = geo_all + mem * (size_t)B * G_ROWS * n_max;
        const double* ser = ser_all + mem * (size_t)B * 2 * nt;
        const double* par_m = par_all + mem * (size_t)B * P_COUNT;
        const double* stor_m = stor_all + mem * (size_t)B * 2 * SP_COUNT;
        const double* stab_m = stab_all + mem * (size_t)stab_stride;
        const double* qlat = qlat_mode == QLAT_NONE ? nullptr
            : qlat_all + mem * (size_t)(qlat_mode == QLAT_LEVELS ? nt : 1) * ld;
        double* depth = depth_all + mem * (size_t)nt * ld;
        double* flow = flow_all + mem * (size_t)nt * ld;
        double* Yout = Y_all + mem * (size_t)nt * J;
        int* iters = iters_all + mem * (size_t)nt;
        double* errs = err_all + mem * (size_t)nt;
        int* conv = conv_all + mem * (size_t)nt;
        double* stage = stage_all + mem * (size_t)nt * B * 2;
        double* gate = gate_all + mem * (size_t)nt * B * 2;

        // the slot arrays: in dynamic shared memory, or in this block's part of
        // the scratch; the junction block and the gate state in shared memory
        double* buf0 = SCRATCH ? scratch_all + blockIdx.x * slot_doubles(ld, RHS)
                               : smem;              // the assembled system / PCR ping
        double* buf1 = buf0 + (size_t)C * LD;      // exchange area / PCR pong / solution
        double* sh = buf1 + (size_t)C * LD;
        double* sQ = sh + LD;
        // the level-start state (BRACKET: in components 7-11 of the assembly
        // buffer, free from the level's start to its first assembly, since
        // only the cell i-1 reads it there, into registers; no inflow array)
        double* shp = BRACKET ? buf0 + 7 * (size_t)LD : sQ + LD;
        double* sQp = BRACKET ? buf0 + 8 * (size_t)LD : shp + LD;
        double* sAp = BRACKET ? buf0 + 9 * (size_t)LD : sQp + LD;
        double* sSep = BRACKET ? buf0 + 10 * (size_t)LD : sAp + LD;
        double* sQ2Ap = BRACKET ? buf0 + 11 * (size_t)LD : sSep + LD;
        double* sqavg = sQ2Ap + LD;
        double* sY = SCRATCH ? smem : BRACKET ? sQ + LD : sqavg + LD;  // junction stage
        // CLUSTER: the junction block and the gate state are rank 0's
        if constexpr (CLUSTER) {
            if (rank != 0) sY = cg::this_cluster().map_shared_rank(sY, 0);
        }
        double* sYp = sY + J;                       // its level-start value
        double* sSp = sYp + J;                      // level-start signed end sum
        double* sqp = sSp + J;                      // level-start rated outflow
        double* srhs = sqp + J;                     // G, then the Schur right-hand side
        double* sdY = srhs + J;                     // dQ_out/dY, then the increment dY
        // the J x J Schur matrix (CLUSTER: only rank 0 forms and solves it, so
        // its own shared memory, addressed as such); per branch the downstream
        // gate state
        double* sM = CLUSTER ? sqavg + LD + 6 * J : sdY + J;
        double* gopen = CLUSTER ? sdY + J + (size_t)J * J : sM + (size_t)J * J;
        double* gcool = gopen + B;
        double* gtime = gcool + B;
        double* gstage = gtime + B;
        // BRACKET: each slot's bracket, [BK_COUNT][ld], and its index
        double* bcache = gstage + B;
        int* bcidx = (int*)(bcache + (size_t)BK_COUNT * ld);

        const double theta = par_m[P_THETA], dt = par_m[P_DT], tol = par_m[P_TOL];
        const double inv2dt = 1.0 / (2.0 * dt);
        const int tid = threadIdx.x, nthr = blockDim.x;
        // the junction block's rank (rank 0) runs the junction, gate and Schur
        // work: tj is the thread's index there, beyond every loop's bound in
        // the other ranks
        const bool lead = !CLUSTER || rank == 0;
        const int tj = lead ? tid : 1 << 30;
        // the junction rows go to the threads that own no slot when there are J
        // of them (junction j on thread slots + j), else to threads 0..J-1
        // (SIDE: among the slots' warps, as without the side warps; j0 is
        // then the junction whose G the thread adds to the norm)
        const int nslot = SIDE ? nthr - SIDE_WARPS * 32 : nthr;
        const int j0 = CLUSTER ? (!lead ? J : nthr - cnt >= J ? (tid >= cnt ? tid - cnt : J) : tid)
                     : SIDE ? (nslot - ld >= J ? (tid >= ld && tid < nslot ? tid - ld : J) : tid)
                            : nthr - ld >= J ? (tid >= ld ? tid - ld : J) : tid;
        Probe<PROBE> probe;
        AssemblyProbe<PROBE> ap;

#define TDIFF(c1, c0, p1, p0) (((c1) + (c0) - (p1) - (p0)) / (2.0 * dt))
#define SDIFF(c1, c0, p1, p0) ((theta * ((c1) - (c0)) + (1.0 - theta) * ((p1) - (p0))) / dx)
#define CAVG(c1, c0, p1, p0) (0.5 * theta * ((c1) + (c0)) + 0.5 * (1.0 - theta) * ((p1) + (p0)))
#define BRANCH_INT(b, f) bint[(b) * BI_COUNT + (f)]

        // the table path: a slot's row of its branch's first table (null for a
        // trapezoid slot)
        const size_t tab_nm = (size_t)n_max * tab_m;
        const double tab_jmax = (double)(tab_m - 2);
        auto table_row = [&](int b, int i) -> const double* {
            const int t = tab_branch[b];
            return t < 0 ? nullptr : tab_all + ((size_t)t * TAB_COUNT * n_max + i) * tab_m;
        };

        // -- the latency build's own slot: indices, branch, geometry in registers
        const bool own = tid < (CLUSTER ? cnt : ld);
        int ob = 0, oi = 0, on_b = 0, ous_j = -1, ods_j = -1;
        double odx = 1.0, oz1 = 0.0;
        Geo og{};
        const double* otab = nullptr;   // TABLE: its table row, and the grid step
        double odgrid = 0.0;
        if constexpr (ONE) {
            if (own) {
                ob = GS(tid) / n_max;
                oi = GS(tid) - ob * n_max;
                on_b = BRANCH_INT(ob, BI_N);
                ous_j = BRANCH_INT(ob, BI_US_J);
                ods_j = BRANCH_INT(ob, BI_DS_J);
                odx = par_m[(size_t)ob * P_COUNT + P_DX];
                og = load_geo(geo, n_max, ob, oi);
                if (oi < n_max - 1) oz1 = geo[((size_t)ob * G_ROWS + G_ZBED) * n_max + oi + 1];
                if constexpr (TABLE) {
                    otab = table_row(ob, oi);
                    odgrid = og.b / (double)(tab_m - 1);   // the table span, row G_BMAIN
                }
            }
        }
        // SIDE: lane e of the ends warp (ew) takes the e-th external end, slot
        // e_s of branch e_b (-1: none), and keeps its level-start h and Q; a
        // slot's index among the external ends, o_e (-1: not one); the warps
        // that wait for the side warps (waits: one of their threads adds an
        // end residual or a junction's G to the norm), and the named
        // barrier's threads
        const int warp = tid >> 5, lane = tid & 31, ew = nslot >> 5;
        int e_s = -1, e_b = 0, o_e = -1, side_count = 0;
        bool e_up = false, waits = false;
        double ehp = 0.0, eQp = 0.0;
        if constexpr (SIDE) {
            int e = 0;
            for (int b = 0; b < B; ++b) {
                for (int up = 1; up >= 0; --up) {
                    if (BRANCH_INT(b, up ? BI_US_J : BI_DS_J) >= 0) continue;
                    const int sl = b * n_max + (up ? 0 : n_max - 1);
                    if (warp == ew && lane == e) { e_s = sl; e_b = b; e_up = up; }
                    if (own && tid == sl) o_e = e;
                    ++e;
                }
            }
            waits = warp < ew && __any_sync(0xffffffffu, o_e >= 0 || j0 < J);
            side_count = 32 * (__syncthreads_count(lane == 0 && waits) + SIDE_WARPS);
        }
        // every slot of this thread: once in the latency build, a loop otherwise
        auto each_slot = [&](auto&& body) {
            if constexpr (ONE) {
                if (own) body(tid, ob, oi);
            } else if constexpr (CLUSTER) {
                for (int s = tid; s < rk.cnt; s += nthr) {
                    const int g = rk.lo + s, b = g / n_max;
                    body(s, b, g - b * n_max);
                }
            } else {
                for (int s = tid; s < ld; s += nthr) {
                    const int b = s / n_max;
                    body(s, b, s - b * n_max);
                }
            }
        };
        // a slot's geometry: in a TABLE build with its tables, so that the
        // closures take its branch's kind (section_state(const SlotGeo&))
        auto geo_at = [&](int b, int i) -> std::conditional_t<TABLE, SlotGeo, Geo> {
            if constexpr (TABLE) {
                if constexpr (ONE) {
                    return SlotGeo{og, otab, tab_nm, odgrid, tab_jmax, og.curv};
                } else {
                    const Geo g = load_geo(geo, n_max, b, i);
                    return SlotGeo{g, table_row(b, i), tab_nm, g.b / (double)(tab_m - 1), tab_jmax, g.curv};
                }
            } else if constexpr (ONE) {
                return og;
            } else {
                return load_geo(geo, n_max, b, i);
            }
        };

        // the latency build's registers: previous-level state of its node (0) and
        // of node i+1 (1), and this iteration's closures of its node
        double ohp0 = 0, oQp0 = 0, oAp0 = 0, oSep0 = 0, oQ2Ap0 = 0, oqavg = 0;
        double ohp1 = 0, oQp1 = 0, oAp1 = 0, oSep1 = 0, oQ2Ap1 = 0;
        double oh = 0, oQ = 0, oQ2A = 0, oQA = 0;
        Sec osc{};
        Slope oe{};

        // lane j of warp 0 (J <= 32): the ends at junction j in the stacked
        // engine's order (branches in order, downstream end first), 2 b + up, so
        // that the lanes form their Schur rows side by side and not one end of
        // the network after another
        int jend[MAX_JUNCTION_ENDS];
        int n_jend = 0;
        if (J >= 2 && J <= 32 && TJ < J) {
            for (int b = 0; b < B; ++b) {
                if (BRANCH_INT(b, BI_DS_J) == TJ) { if (n_jend < MAX_JUNCTION_ENDS) jend[n_jend] = 2 * b; ++n_jend; }
                if (BRANCH_INT(b, BI_US_J) == TJ) { if (n_jend < MAX_JUNCTION_ENDS) jend[n_jend] = 2 * b + 1; ++n_jend; }
            }
        }

        each_slot([&](int s, int, int) {
            sh[s] = h0_all[mem * (size_t)ld + GS(s)];
            sQ[s] = Q0_all[mem * (size_t)ld + GS(s)];
            depth[GS(s)] = sh[s];
            flow[GS(s)] = sQ[s];
            if constexpr (BRACKET) bcidx[s] = -1;
        });
        for (int j = TJ; j < J; j += nthr) {
            sY[j] = Y0_all[mem * (size_t)J + j];
            Yout[j] = sY[j];
        }
        for (int b = TJ; b < B; b += nthr) {
            const double* par = par_m + (size_t)b * P_COUNT;
            const double g0 = par[P_GATE_INIT];
            gopen[b] = BRANCH_INT(b, BI_DS_J) < 0 ? g0 : 0.0;
            gcool[b] = 0.0;
            gtime[b] = -1.0;
            gate[b * 2 + 0] = BRANCH_INT(b, BI_US_J) < 0 ? g0 : 0.0;
            gate[b * 2 + 1] = gopen[b];
        }
        if (TJ == 0) { iters[0] = 0; errs[0] = 0.0; conv[0] = 1; }
        NET_SYNC();
        probe.start();
        for (int b = TJ; b < B; b += nthr)
            gstage[b] = par_m[(size_t)b * P_COUNT + P_DS_BED_LEVEL] + ATG(sh, b * n_max + n_max - 1);

        for (int k = 1; k < nt; ++k) {
            // -- level start: pads re-anchored to their branch's end
            each_slot([&](int s, int b, int i) {
                const int n_b = ONE ? on_b : BRANCH_INT(b, BI_N);
                if (i >= n_b) { sh[s] = ATG(sh, b * n_max + n_b - 1); sQ[s] = ATG(sQ, b * n_max + n_b - 1); }
            });
            // the gate controller of a gated downstream rating, on the stage the
            // previous level left
            for (int b = TJ; b < B; b += nthr) {
                if (BRANCH_INT(b, BI_DS_KIND) != BC_RATING || BRANCH_INT(b, BI_RC_KIND) != RC_GATED) continue;
                const double* par = par_m + (size_t)b * P_COUNT;
                const double pivot = par[P_RC_PIVOT], time = (double)k * dt;
                const double elapsed = gtime[b] >= 0.0 ? time - gtime[b] : 0.0;
                double cool = clamp_min(gcool[b] - elapsed, 0.0);
                const bool can_act = cool <= 0.0;
                const bool do_open = can_act && (gstage[b] >= pivot + 0.5) && (gopen[b] < 0.5);
                const bool do_close = can_act && (gstage[b] <= pivot - 1.0) && (gopen[b] > 0.5);
                gopen[b] = do_open ? 1.0 : (do_close ? 0.0 : gopen[b]);
                gcool[b] = (do_open || do_close) ? par[P_RC_COOLDOWN] : cool;
                gtime[b] = time;
            }
            NET_SYNC();
            probe.mark(PH_LEVEL);

            // -- previous-level state per slot; junction level-start terms
            each_slot([&](int s, int b, int i) {
                // the slot's level-start inflow (cell i, i+1)
                auto inflow = [&]() {
                    double qa = 0.0;
                    if (qlat_mode != QLAT_NONE && i < n_max - 1) {
                        const double* qc = qlat_mode == QLAT_LEVELS ? qlat + (size_t)k * ld : qlat;
                        const double* qp = qlat_mode == QLAT_LEVELS ? qlat + (size_t)(k - 1) * ld : qlat;
                        qa = CAVG(qc[GS(s) + 1], qc[GS(s)], qp[GS(s) + 1], qp[GS(s)]);
                    }
                    return qa;
                };
                if constexpr (LEAN) {
                    // h, Q and the inflow: the closures come with the first
                    // iteration's
                    ohp0 = sh[s]; oQp0 = sQ[s]; oqavg = inflow();
                } else {
                    const double h = sh[s], Q = sQ[s];
                    const auto g = geo_at(b, i);
                    const Sec sc = slot_section<BRACKET>(g, h, bcache, bcidx, ld, s);
                    const Slope e = energy_slope(g, sc, h, Q);
                    const double Q2A = Q * Q / sc.A;
                    shp[s] = h; sQp[s] = Q;
                    sAp[s] = sc.A; sSep[s] = e.Se; sQ2Ap[s] = Q2A;
                    const double qa = inflow();
                    if constexpr (!BRACKET) sqavg[s] = qa;
                    if constexpr (ONE) { ohp0 = h; oQp0 = Q; oAp0 = sc.A; oSep0 = e.Se; oQ2Ap0 = Q2A; oqavg = qa; }
                }
            });
            if constexpr (SIDE) {   // the ends warp's level-start state of its end
                if (e_s >= 0) { ehp = sh[e_s]; eQp = sQ[e_s]; }
            }
            for (int j = j0; j < J; j += nthr) {
                const double* jp = jpar + (size_t)j * JP_COUNT;
                double S = 0.0;
                for (int b = 0; b < B; ++b) {
                    if (BRANCH_INT(b, BI_DS_J) == j) S += ATG(sQ, b * n_max + n_max - 1);
                    if (BRANCH_INT(b, BI_US_J) == j) S += -ATG(sQ, b * n_max);
                }
                sYp[j] = sY[j];
                sSp[j] = S;
                sqp[j] = junction_q(jp, jtab, sY[j]);
            }
            // (LEAN: what the junction rows read here, the closures' barrier
            // publishes)
            if constexpr (!LEAN) {
                NET_SYNC();
                probe.mark(PH_PREV);
            }
            if constexpr (ONE && !LEAN) {
                if (own && oi < n_max - 1) {
                    const int t = tid + 1;
                    ohp1 = AT(shp, t); oQp1 = AT(sQp, t); oAp1 = AT(sAp, t); oSep1 = AT(sSep, t);
                    oQ2Ap1 = AT(sQ2Ap, t);
                }
            }

            // -- while-Newton on the pre-update residual
            double err = CUDART_INF;
            int it = 0;
            while (err >= tol && it < max_iter) {
                // closures of every slot into the exchange area
                each_slot([&](int s, int b, int i) {
                    const double h = sh[s], Q = sQ[s];
                    const auto g = geo_at(b, i);
                    const Sec sc = slot_section<BRACKET, LEAN>(g, h, bcache, bcidx, ld, s);
                    const Slope e = energy_slope(g, sc, h, Q);
                    const double Q2A = Q * Q / sc.A, QA = Q / sc.A;
                    buf1[0 * LD + s] = sc.A;      buf1[1 * LD + s] = Q2A;
                    buf1[2 * LD + s] = e.Se;      buf1[3 * LD + s] = sc.dA_dh;
                    buf1[4 * LD + s] = e.dSe_dA;  buf1[5 * LD + s] = e.dSe_dQ;
                    buf1[6 * LD + s] = QA;
                    if constexpr (BRACKET) {
                        // what an end row reads of the section, beside the
                        // exchange area (no Sec held in registers)
                        oh = h; oQ = Q;
                        if constexpr (LEAN) {
                            if (it == 0) { oAp0 = sc.A; oSep0 = e.Se; oQ2Ap0 = Q2A; }
                        }
                        if (i == 0 || i == n_max - 1) {
                            buf1[7 * LD + s] = sc.R;      buf1[8 * LD + s] = sc.n_eq;
                            buf1[9 * LD + s] = sc.dR_dA;  buf1[10 * LD + s] = sc.K;
                            buf1[11 * LD + s] = sc.dK_dA;
                        }
                    } else if constexpr (ONE) {
                        oh = h; oQ = Q; osc = sc; oe = e; oQ2A = Q2A; oQA = QA;
                    }
                });
                NET_SYNC();
                probe.mark(PH_CLOSURES);
                ap.begin(probe.t);

                double sq = 0.0;
                each_slot([&](int s, int b, int i) {
                    ap.start();
                    const int n_b = ONE ? on_b : BRANCH_INT(b, BI_N);
                    const int us_j = ONE ? ous_j : BRANCH_INT(b, BI_US_J);
                    const int ds_j = ONE ? ods_j : BRANCH_INT(b, BI_DS_J);
                    const double* par = par_m + (size_t)b * P_COUNT;
                    const double dx = ONE ? odx : par[P_DX];
                    const double th_dx = theta / dx;
                    // this slot's own values: registers in the latency build
                    double h, Q, A0, Q2A0, Se0, dA_dh0, dSe_dA0, dSe_dQ0, QA0;
                    if constexpr (ONE && !BRACKET) {
                        h = oh; Q = oQ; A0 = osc.A; Q2A0 = oQ2A; Se0 = oe.Se; dA_dh0 = osc.dA_dh;
                        dSe_dA0 = oe.dSe_dA; dSe_dQ0 = oe.dSe_dQ; QA0 = oQA;
                    } else {
                        h = sh[s]; Q = sQ[s];
                        A0 = buf1[0 * LD + s]; Q2A0 = buf1[1 * LD + s]; Se0 = buf1[2 * LD + s];
                        dA_dh0 = buf1[3 * LD + s]; dSe_dA0 = buf1[4 * LD + s];
                        dSe_dQ0 = buf1[5 * LD + s]; QA0 = buf1[6 * LD + s];
                    }
                    // structural zeros (L row 1, U row 0) and the coupling columns
                    buf0[2 * LD + s] = 0.0; buf0[3 * LD + s] = 0.0;
                    buf0[8 * LD + s] = 0.0; buf0[9 * LD + s] = 0.0;
#pragma unroll
                    for (int r = 1; r < RHS; ++r) { buf0[(12 + 2 * r) * LD + s] = 0.0; buf0[(13 + 2 * r) * LD + s] = 0.0; }

                    if (i < n_max - 1) {          // cell (i, i+1): node i row 1, node i+1 row 0
                        const int t = s + 1;      // (CLUSTER: in the next rank at this rank's edge)
                        if (i < n_b - 1) {
                            const double h1 = AT(sh, t), Q1 = AT(sQ, t);
                            const double A1 = ATC(buf1, 0, t), Q2A1 = ATC(buf1, 1, t);
                            const double Se1 = ATC(buf1, 2, t), dA_dh1 = ATC(buf1, 3, t);
                            const double dSe_dA1 = ATC(buf1, 4, t), dSe_dQ1 = ATC(buf1, 5, t);
                            const double QA1 = ATC(buf1, 6, t);
                            if constexpr (LEAN) {   // the level's first iteration: its state is the level's start
                                if (it == 0) { ohp1 = h1; oQp1 = Q1; oAp1 = A1; oSep1 = Se1; oQ2Ap1 = Q2A1; }
                            }
                            double hp0, hp1, Qp0, Qp1, Ap0, Ap1, Sep0, Sep1, Q2Ap0, Q2Ap1, qavg, z0, z1;
                            if constexpr (ONE) {
                                hp0 = ohp0; hp1 = ohp1; Qp0 = oQp0; Qp1 = oQp1; Ap0 = oAp0; Ap1 = oAp1;
                                Sep0 = oSep0; Sep1 = oSep1; Q2Ap0 = oQ2Ap0; Q2Ap1 = oQ2Ap1; qavg = oqavg;
                                z0 = og.z; z1 = oz1;
                            } else {
                                hp0 = shp[s]; hp1 = AT(shp, t); Qp0 = sQp[s]; Qp1 = AT(sQp, t);
                                Ap0 = sAp[s]; Ap1 = AT(sAp, t); Sep0 = sSep[s]; Sep1 = AT(sSep, t);
                                Q2Ap0 = sQ2Ap[s]; Q2Ap1 = AT(sQ2Ap, t); qavg = sqavg[s];
                                z0 = geo[((size_t)b * G_ROWS + G_ZBED) * n_max + i];
                                z1 = geo[((size_t)b * G_ROWS + G_ZBED) * n_max + i + 1];
                            }

                            double Rc = TDIFF(A1, A0, Ap1, Ap0) + SDIFF(Q1, Q, Qp1, Qp0);
                            if (qlat_mode != QLAT_NONE) Rc = Rc - qavg;
                            const double avgA = CAVG(A1, A0, Ap1, Ap0);
                            const double dYdx = (z1 - z0) / dx + SDIFF(h1, h, hp1, hp0);
                            const double avgSe = CAVG(Se1, Se0, Sep1, Sep0);
                            const double Rm = TDIFF(Q1, Q, Qp1, Qp0) + SDIFF(Q2A1, Q2A0, Q2Ap1, Q2Ap0)
                                + G * avgA * (dYdx + avgSe);
                            const double geom = dYdx + avgSe;
                            const double dM_dh_i = (th_dx * (QA0 * QA0) * dA_dh0
                                + G * (avgA * (-th_dx + 0.5 * theta * dSe_dA0 * dA_dh0)
                                       + 0.5 * theta * dA_dh0 * geom));
                            const double dM_dh_i1 = (-th_dx * (QA1 * QA1) * dA_dh1
                                + G * (avgA * (th_dx + 0.5 * theta * dSe_dA1 * dA_dh1)
                                       + 0.5 * theta * dA_dh1 * geom));
                            const double dM_dQ_i = inv2dt - th_dx * 2.0 * QA0 + G * avgA * 0.5 * theta * dSe_dQ0;
                            const double dM_dQ_i1 = inv2dt + th_dx * 2.0 * QA1 + G * avgA * 0.5 * theta * dSe_dQ1;
                            buf0[6 * LD + s] = dA_dh0 * inv2dt;  buf0[7 * LD + s] = -th_dx;
                            buf0[10 * LD + s] = dA_dh1 * inv2dt; buf0[11 * LD + s] = th_dx;
                            buf0[13 * LD + s] = -Rc;
                            ATC(buf0, 0, t) = dM_dh_i;   ATC(buf0, 1, t) = dM_dQ_i;
                            ATC(buf0, 4, t) = dM_dh_i1;  ATC(buf0, 5, t) = dM_dQ_i1;
                            ATC(buf0, 12, t) = -Rm;
                            sq += Rc * Rc + Rm * Rm;
                        } else {                  // pad cell: delta-copy rows, no residual in the norm
                            buf0[6 * LD + s] = -1.0;  buf0[7 * LD + s] = 0.0;
                            buf0[10 * LD + s] = 1.0;  buf0[11 * LD + s] = 0.0;
                            buf0[13 * LD + s] = -(AT(sh, t) - h);
                            ATC(buf0, 0, t) = 0.0;   ATC(buf0, 1, t) = -1.0;
                            ATC(buf0, 4, t) = 0.0;   ATC(buf0, 5, t) = 1.0;
                            ATC(buf0, 12, t) = -(AT(sQ, t) - Q);
                        }
                    }
                    ap.mark(0);
                    if (i == 0 || i == n_max - 1) {   // the branch's end rows
                        const bool up = i == 0;
                        const int jid = up ? us_j : ds_j;
                        double res, df_dh, df_dQ;
                        // D row 0 of node 0 (upstream) or row 1 of node Nmax-1 (downstream)
                        double* p_dh = &buf0[(up ? 4 : 6) * LD + s];
                        double* p_dq = &buf0[(up ? 5 : 7) * LD + s];
                        double* p_b = &buf0[(up ? 12 : 13) * LD + s];
                        if (up) { buf0[0 * LD + s] = 0.0; buf0[1 * LD + s] = 0.0; }
                        else { buf0[10 * LD + s] = 0.0; buf0[11 * LD + s] = 0.0; }
                        if (jid >= 0) {
                            const double z = ONE ? og.z : geo[((size_t)b * G_ROWS + G_ZBED) * n_max + i];
                            res = h - (sY[jid] - z);
                            *p_dh = 1.0; *p_dq = 0.0; *p_b = -res;
                            // its -1 coupling column: the upstream coupling first
                            const int col = 1 + (up ? 0 : (us_j >= 0 ? 1 : 0));
                            buf0[(12 + 2 * col + (up ? 0 : 1)) * LD + s] = -1.0;
                        } else if constexpr (!SIDE) {   // (SIDE: the ends warp's)
                            Sec sc;
                            if constexpr (BRACKET) {   // what the closures kept
                                sc.A = buf1[0 * LD + s];   sc.T = buf1[3 * LD + s];   sc.dA_dh = sc.T;
                                sc.R = buf1[7 * LD + s];   sc.n_eq = buf1[8 * LD + s];
                                sc.dR_dA = buf1[9 * LD + s];
                                sc.K = buf1[10 * LD + s];  sc.dK_dA = buf1[11 * LD + s];
                            } else if constexpr (ONE) sc = osc;
                            else if constexpr (TABLE) sc = section_state(geo_at(b, i), h);
                            else sc = section_state(load_geo(geo, n_max, b, i), h);
                            const int kind = BRANCH_INT(b, up ? BI_US_KIND : BI_DS_KIND);
                            const int sflags = BRANCH_INT(b, up ? BI_US_SFLAGS : BI_DS_SFLAGS);
                            const double bed = par[up ? P_US_BED_LEVEL : P_DS_BED_LEVEL];
                            double* st = &stage[((size_t)k * B + b) * 2 + (up ? 0 : 1)];
                            if (kind == BC_FIXED && (sflags & ST_ON)) {
                                // level 1: upstream anchors on the previous level's
                                // surface, downstream on the current trial stage;
                                // later levels on the stage this thread stored
                                const double hp_s = ONE ? ohp0 : shp[s];
                                const double Y_old = k == 1 ? (up ? hp_s : h) + bed
                                    : stage[((size_t)(k - 1) * B + b) * 2 + (up ? 0 : 1)];
                                const int nv = BRANCH_INT(b, up ? BI_US_NV : BI_DS_NV);
                                const int na = BRANCH_INT(b, up ? BI_US_NA : BI_DS_NA);
                                const int nr = BRANCH_INT(b, up ? BI_US_NR : BI_DS_NR);
                                const int off = BRANCH_INT(b, BI_TAB_OFF)
                                    + (up ? 0 : 2 * (BRANCH_INT(b, BI_US_NV) + BRANCH_INT(b, BI_US_NA))
                                                    + BRANCH_INT(b, BI_US_NR));
                                res = storage_row(stor_m + ((size_t)b * 2 + (up ? 0 : 1)) * SP_COUNT, stab_m + off,
                                                  sflags, nv, na, nr, up ? -1.0 : 1.0, bed, dt, ONE ? oQp0 : sQp[s],
                                                  Y_old, sc.A, sc.R, sc.n_eq, sc.dR_dA, sc.dA_dh, h, Q, p_dh, p_dq, p_b,
                                                  st);
                            } else {
                                Bc bc = up ? Bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], kind}
                                           : Bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], kind};
                                Rating rat{};
                                if (kind == BC_RATING)
                                    rat = up ? Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                                      par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                                      par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                                      par[P_URC_FD], 0.0, BRANCH_INT(b, BI_URC_KIND)}
                                             : Rating{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
                                                      par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
                                                      par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER],
                                                      par[P_RC_FD], par[P_RC_COOLDOWN], BRANCH_INT(b, BI_RC_KIND)};
                                const double target = ser[((size_t)b * 2 + (up ? 0 : 1)) * nt + k];
                                boundary_row(bc, rat, sc, h, Q, target, up ? 0.0 : gopen[b], res, df_dh, df_dQ);
                                *p_dh = df_dh; *p_dq = df_dQ; *p_b = -res;
                            }
                        }
                        if constexpr (SIDE) {
                            if (jid >= 0) sq += res * res;
                        } else {
                            sq += res * res;
                        }
                    }
                    ap.mark(1);
                });
                // junction rows: G_j, and dQ_out/dY for the Schur diagonal (SIDE:
                // the side warps' rows and the threads that add them to the
                // norm, below)
                if constexpr (!SIDE) {
                for (int j = j0; j < J; j += nthr) {
                    const double* jp = jpar + (size_t)j * JP_COUNT;
                    double S = 0.0;
                    for (int b = 0; b < B; ++b) {
                        if (BRANCH_INT(b, BI_DS_J) == j) S += ATG(sQ, b * n_max + n_max - 1);
                        if (BRANCH_INT(b, BI_US_J) == j) S += -ATG(sQ, b * n_max);
                    }
                    const double area = jp[JP_AREA];
                    const double q = junction_q(jp, jtab, sY[j]);
                    const double Gj = area > 0.0
                        ? area * (sY[j] - sYp[j]) / dt - 0.5 * (S + sSp[j]) + 0.5 * (q + sqp[j])
                        : S - q;
                    srhs[j] = Gj;
                    sdY[j] = junction_dq(jp, jtab, sY[j]);
                    sq += Gj * Gj;
                }
                } else {
                    // SIDE: lane e of the ends warp the e-th external end's row,
                    // lane j of the junction warp junction j's, the rows above in
                    // their arithmetic (the other builds keep their own text of
                    // them: through a shared function their ptxas figures moved);
                    // the slots' warps that add them to the norm wait for them,
                    // then add them in their place
                    double* side = side_area<SIDE>();
                    if (warp == ew) {
                        if (e_s >= 0) {
                            const int s = e_s, b = e_b;
                            const bool up = e_up;
                            const double h = sh[s], Q = sQ[s];
                            const double* par = par_m + (size_t)b * P_COUNT;
                            double* p_dh = &buf0[(up ? 4 : 6) * LD + s];
                            double* p_dq = &buf0[(up ? 5 : 7) * LD + s];
                            double* p_b = &buf0[(up ? 12 : 13) * LD + s];
                            double res, df_dh, df_dQ;
                            Sec sc;   // what the closures kept
                            sc.A = buf1[0 * LD + s];   sc.T = buf1[3 * LD + s];   sc.dA_dh = sc.T;
                            sc.R = buf1[7 * LD + s];   sc.n_eq = buf1[8 * LD + s];
                            sc.dR_dA = buf1[9 * LD + s];
                            sc.K = buf1[10 * LD + s];  sc.dK_dA = buf1[11 * LD + s];
                            const int kind = BRANCH_INT(b, up ? BI_US_KIND : BI_DS_KIND);
                            const int sflags = BRANCH_INT(b, up ? BI_US_SFLAGS : BI_DS_SFLAGS);
                            const double bed = par[up ? P_US_BED_LEVEL : P_DS_BED_LEVEL];
                            double* st = &stage[((size_t)k * B + b) * 2 + (up ? 0 : 1)];
                            if (kind == BC_FIXED && (sflags & ST_ON)) {
                                const double Y_old = k == 1 ? (up ? ehp : h) + bed
                                    : stage[((size_t)(k - 1) * B + b) * 2 + (up ? 0 : 1)];
                                const int nv = BRANCH_INT(b, up ? BI_US_NV : BI_DS_NV);
                                const int na = BRANCH_INT(b, up ? BI_US_NA : BI_DS_NA);
                                const int nr = BRANCH_INT(b, up ? BI_US_NR : BI_DS_NR);
                                const int off = BRANCH_INT(b, BI_TAB_OFF)
                                    + (up ? 0 : 2 * (BRANCH_INT(b, BI_US_NV) + BRANCH_INT(b, BI_US_NA))
                                                    + BRANCH_INT(b, BI_US_NR));
                                res = storage_row(stor_m + ((size_t)b * 2 + (up ? 0 : 1)) * SP_COUNT, stab_m + off,
                                                  sflags, nv, na, nr, up ? -1.0 : 1.0, bed, dt, eQp, Y_old, sc.A,
                                                  sc.R, sc.n_eq, sc.dR_dA, sc.dA_dh, h, Q, p_dh, p_dq, p_b, st);
                            } else {
                                Bc bc = up ? Bc{par[P_US_BED_LEVEL], par[P_US_BED_SLOPE], par[P_US_INIT_DEPTH], kind}
                                           : Bc{par[P_DS_BED_LEVEL], par[P_DS_BED_SLOPE], par[P_DS_INIT_DEPTH], kind};
                                Rating rat{};
                                if (kind == BC_RATING)
                                    rat = up ? Rating{par[P_URC_LOW0], par[P_URC_LOW1], par[P_URC_LOW2],
                                                      par[P_URC_HIGH0], par[P_URC_HIGH1], par[P_URC_HIGH2],
                                                      par[P_URC_SHIFT], par[P_URC_PIVOT], par[P_URC_BUFFER],
                                                      par[P_URC_FD], 0.0, BRANCH_INT(b, BI_URC_KIND)}
                                             : Rating{par[P_RC_LOW0], par[P_RC_LOW1], par[P_RC_LOW2],
                                                      par[P_RC_HIGH0], par[P_RC_HIGH1], par[P_RC_HIGH2],
                                                      par[P_RC_SHIFT], par[P_RC_PIVOT], par[P_RC_BUFFER],
                                                      par[P_RC_FD], par[P_RC_COOLDOWN], BRANCH_INT(b, BI_RC_KIND)};
                                const double target = ser[((size_t)b * 2 + (up ? 0 : 1)) * nt + k];
                                boundary_row(bc, rat, sc, h, Q, target, up ? 0.0 : gopen[b], res, df_dh, df_dQ);
                                *p_dh = df_dh; *p_dq = df_dQ; *p_b = -res;
                            }
                            side[lane] = res;
                        }
                        side_arrive(side_count);
                    } else if (warp == ew + 1) {
                        for (int j = lane; j < J; j += 32) {
                            const double* jp = jpar + (size_t)j * JP_COUNT;
                            double S = 0.0;
                            for (int b = 0; b < B; ++b) {
                                if (BRANCH_INT(b, BI_DS_J) == j) S += sQ[b * n_max + n_max - 1];
                                if (BRANCH_INT(b, BI_US_J) == j) S += -sQ[b * n_max];
                            }
                            const double area = jp[JP_AREA];
                            const double q = junction_q(jp, jtab, sY[j]);
                            const double Gj = area > 0.0
                                ? area * (sY[j] - sYp[j]) / dt - 0.5 * (S + sSp[j]) + 0.5 * (q + sqp[j])
                                : S - q;
                            srhs[j] = Gj;
                            sdY[j] = junction_dq(jp, jtab, sY[j]);
                            side[32 + j] = Gj;
                        }
                        side_arrive(side_count);
                    } else if (waits) {
                        side_wait(side_count);
                        if (o_e >= 0) sq += side[o_e] * side[o_e];
                        if (j0 < J) sq += side[32 + j0] * side[32 + j0];
                    }
                }
                ap.mark(2);
                ap.publish();
                // the barrier inside publishes buf0 and retires every read of the
                // exchange area before the first sweep overwrites it
                if constexpr (CLUSTER) err = sqrt(cluster_sum(sq, warp_part[it & 1], it & 1));
                else err = sqrt(block_sum(sq, warp_part[it & 1]));
                probe.mark(PH_ASSEMBLY);
                ap.account(probe.active, probe.t);

                double* src = buf0;
                double* dst = buf1;
                int stride = 1;
                // BRACKET: the slot's own rows and its inverse of D in registers
                double o[C + 4];
                if constexpr (BRACKET) {
                    if (own) {
#pragma unroll
                        for (int c = 0; c < C; ++c) o[c] = buf0[c * ld + tid];
                    }
                }
                for (int sw = 0; sw < sweeps; ++sw, stride *= 2) {
                    each_slot([&](int s, int b, int i) {
                        if constexpr (BRACKET) {
                            // the partners at i -/+ stride in the branch's segment
                            const bool vm = i - stride >= 0, vp = i + stride < n_max;
                            const double* pm = vm ? src + (s - stride) : src;
                            const double* pp = vp ? src + (s + stride) : src;
                            if (sw == 0) pcr::sweep_node_at_carried<RHS, false>(o, pm, pp, dst + s, ld, vm, vp);
                            else pcr::sweep_node_at_carried<RHS, true>(o, pm, pp, dst + s, ld, vm, vp);
                        } else if constexpr (CLUSTER) {
                            // the partners at i -/+ stride, in any rank
                            const bool vm = i - stride >= 0, vp = i + stride < n_max;
                            pcr::sweep_node_at<RHS>(src + s, vm ? &AT(src, s - stride) : src,
                                                    vp ? &AT(src, s + stride) : src, dst + s, LD, vm, vp);
                        } else {
                            pcr::sweep_node<RHS>(src + b * n_max, dst + b * n_max, ld, n_max, stride, i);
                        }
                    });
                    NET_SYNC();
                    probe.mark(PH_SWEEPS);
                    double* tmp = src; src = dst; dst = tmp;
                }
                // the solution columns (x[2r + row]) into the free buffer
                each_slot([&](int s, int b, int i) {
                    double x[2 * RHS];
                    if constexpr (BRACKET) {   // backsolve_node on the rows in registers
#pragma unroll
                        for (int r = 0; r < RHS; ++r) {
                            x[2 * r] = o[C + 0] * o[12 + 2 * r] + o[C + 1] * o[13 + 2 * r];
                            x[2 * r + 1] = o[C + 2] * o[12 + 2 * r] + o[C + 3] * o[13 + 2 * r];
                        }
                    } else if constexpr (CLUSTER) pcr::backsolve_node<RHS>(src, LD, s, x);
                    else pcr::backsolve_node<RHS>(src + b * n_max, ld, i, x);
#pragma unroll
                    for (int c = 0; c < 2 * RHS; ++c) dst[c * LD + s] = x[c];
                });
                NET_SYNC();
                probe.mark(PH_BACKSOLVE);
                double* X = dst;

                // the Schur system, in the stacked engine's order: row j from the
                // end values of the solution columns of the branches at junction
                // j, downstream end first
                double dY1 = 0.0;        // J = 1: the increment, formed by every thread
                if (J == 1) {
                    const double area = jpar[JP_AREA];
                    const double D_Y = area > 0.0 ? area / dt + 0.5 * sdY[0] : -sdY[0];
                    const double fac = area > 0.0 ? -0.5 : 1.0;
                    double m = 0.0, rhs = srhs[0];
                    for (int b = 0; b < B; ++b) {
                        const int us_j = BRANCH_INT(b, BI_US_J), ds_j = BRANCH_INT(b, BI_DS_J);
                        for (int e = 0; e < 2; ++e) {
                            const bool up = e == 1;
                            if ((up ? us_j : ds_j) != 0) continue;
                            const int s = LS(b * n_max + (up ? 0 : n_max - 1));
                            const double fs = fac * (up ? -1.0 : 1.0);
                            rhs += fs * ATC(X, 1, s);
                            int ci = 0;
                            if (us_j >= 0) { m += fs * ATC(X, (2 * (1 + ci) + 1), s); ++ci; }
                            if (ds_j >= 0) { m += fs * ATC(X, (2 * (1 + ci) + 1), s); }
                        }
                    }
                    m = m - D_Y;
                    dY1 = rhs / m;
                } else {
                    // junction j's row by lane j of warp 0 when J <= 32 (then the
                    // rows and their solve need no block barrier between them),
                    // over its list of ends
                    const bool warp0 = J <= 32;
                    for (int j = TJ; j < J && (!warp0 || TJ < 32); j += (warp0 ? 32 : nthr)) {
                        const double area = jpar[(size_t)j * JP_COUNT + JP_AREA];
                        const double fac = area > 0.0 ? -0.5 : 1.0;
                        const double D_Y = area > 0.0 ? area / dt + 0.5 * sdY[j] : -sdY[j];
                        double* row = sM + (size_t)j * J;
                        for (int c = 0; c < J; ++c) row[c] = 0.0;
                        double rhs = srhs[j];
                        auto add_end = [&](int b, bool up) {
                            const int us_j = BRANCH_INT(b, BI_US_J), ds_j = BRANCH_INT(b, BI_DS_J);
                            const int s = LS(b * n_max + (up ? 0 : n_max - 1));
                            const double fs = fac * (up ? -1.0 : 1.0);
                            rhs += fs * ATC(X, 1, s);
                            int ci = 0;
                            if (us_j >= 0) { row[us_j] += fs * ATC(X, (2 * (1 + ci) + 1), s); ++ci; }
                            if (ds_j >= 0) { row[ds_j] += fs * ATC(X, (2 * (1 + ci) + 1), s); }
                        };
                        if (warp0 && n_jend <= MAX_JUNCTION_ENDS) {
                            for (int e = 0; e < n_jend; ++e) add_end(jend[e] >> 1, jend[e] & 1);
                        } else {
                            for (int b = 0; b < B; ++b) {       // downstream end first
                                if (BRANCH_INT(b, BI_DS_J) == j) add_end(b, false);
                                if (BRANCH_INT(b, BI_US_J) == j) add_end(b, true);
                            }
                        }
                        row[j] = row[j] - D_Y;
                        srhs[j] = rhs;
                    }
                    if (warp0) {
                        __syncwarp();
                    } else {
                        __syncthreads();
                        probe.mark(PH_SCHUR);
                    }
                    // dY into sdY by warp 0 (the rows above have read its dQ_out/dY)
                    if (TJ < 32) warp_gauss_jordan(sM, srhs, sdY, J, tid);
                    NET_SYNC();
                    probe.mark(PH_JSOLVE);
                }
                auto dY_of = [&](int j) { return J == 1 ? dY1 : sdY[j]; };

                // dx = u - V dY per slot; Y += dY
                each_slot([&](int s, int b, int i) {
                    const int us_j = ONE ? ous_j : BRANCH_INT(b, BI_US_J);
                    const int ds_j = ONE ? ods_j : BRANCH_INT(b, BI_DS_J);
                    double d[RHS > 1 ? RHS - 1 : 1];
#pragma unroll
                    for (int m = 0; m < RHS - 1; ++m) d[m] = 0.0;
                    int ci = 0;
                    if (us_j >= 0) d[ci++] = dY_of(us_j) * 1.0;
                    if (ds_j >= 0) d[ci] = dY_of(ds_j) * 1.0;
                    double dh, dq;
                    if constexpr (RHS == 2) {
                        dh = X[0 * LD + s] - X[2 * LD + s] * d[0];
                        dq = X[1 * LD + s] - X[3 * LD + s] * d[0];
                    } else {
                        dh = X[0 * LD + s] - (X[2 * LD + s] * d[0] + X[4 * LD + s] * d[1]);
                        dq = X[1 * LD + s] - (X[3 * LD + s] * d[0] + X[5 * LD + s] * d[1]);
                    }
                    const double h = ONE ? oh : sh[s], Q = ONE ? oQ : sQ[s];
                    sh[s] = h + dh;
                    sQ[s] = Q + dq;
                });
                for (int j = TJ; j < J; j += nthr) sY[j] = sY[j] + dY_of(j);
                ++it;
                NET_SYNC();
                probe.mark(PH_UPDATE);
            }

            // -- the level's records
            each_slot([&](int s, int, int) {
                depth[(size_t)k * ld + GS(s)] = sh[s];
                flow[(size_t)k * ld + GS(s)] = sQ[s];
            });
            for (int j = TJ; j < J; j += nthr) Yout[(size_t)k * J + j] = sY[j];
            for (int b = TJ; b < B; b += nthr) {
                gate[((size_t)k * B + b) * 2 + 0] = gate[b * 2 + 0];
                gate[((size_t)k * B + b) * 2 + 1] = gopen[b];
                gstage[b] = par_m[(size_t)b * P_COUNT + P_DS_BED_LEVEL] + ATG(sh, b * n_max + n_max - 1);
            }
            if (TJ == 0) {
                iters[k] = it;
                errs[k] = err;
                conv[k] = err < tol ? 1 : 0;
            }
            // the next level's pad re-sync must not overwrite an end read above
            NET_SYNC();
            probe.mark(PH_LEVEL);
        }
        probe.write(probe_out);
        ap.write(probe.active, probe_out);
        // the next member's set-up must not overwrite what this one still
        // reads, and (CLUSTER) no rank exits while another can read its
        // shared memory
        if constexpr (SCRATCH || CLUSTER) NET_SYNC();
    } while ((SCRATCH || CLUSTER) && (mem += CLUSTER ? gridDim.x / n_ranks : gridDim.x) < (size_t)n_members);
#undef NET_SYNC
#undef AT
#undef ATG
#undef GS
#undef LS
#undef LD
#undef TJ
#undef ATC
#undef TDIFF
#undef SDIFF
#undef CAVG
#undef BRANCH_INT
}

// Every build has one signature: a build is a kernel pointer.
using NetKernel = decltype(&fused_network_kernel<2, MAX_THREADS, 1, false, false, false, false, false>);

int threads_for(int slots) {
    const int t = ((slots + 31) / 32) * 32;
    return t > MAX_THREADS ? MAX_THREADS : t;
}

// The residency build is the latency build's form (one slot a thread, so
// slots <= MAX_THREADS) under a launch bound of two blocks of the block's
// size, 192 threads (the tributary's 183 slots) or MAX_THREADS:
// 65536 / (2 * BLOCK) registers a thread, rounded down to 8 — 168 at 192
// threads, 128 at 256.  A network with more slots than threads has no
// residency build: the loop build runs every batch of it.  The SCRATCH
// build is the loop build's form; it runs any network, forced on one that
// fits shared memory too.  The CLUSTER build (slots: a rank's) is the
// latency form at one slot a thread, the loop form beyond, or (pair) the
// residency build's 192-thread form.  The BRACKET build is the residency
// form with the bracket cache; the LEAN build its form under the latency
// build's launch bound, and the LEAN_SIDE build the LEAN build with two side
// warps beyond the slots'.  The probe builds are those of the loop, latency, scratch and
// cluster forms, and of the BRACKET and LEAN forms; the scratch and cluster
// ones only in the trapezoid library, the BRACKET and LEAN ones only in the
// table library.  This library's builds are those of networks with table
// branches or those of trapezoid networks (LIB_TABLE).
template <int RHS>
int pick_rhs(int build, int slots, bool probe, bool pair, NetKernel* out) {
    const bool one = slots <= MAX_THREADS;
    if ((probe && (build == RESIDENCY_BUILD || pair)) || (pair && build != CLUSTER_BUILD))
        return (int)cudaErrorInvalidValue;
    switch (build) {
    case LOOP_BUILD:
        *out = probe ? &fused_network_kernel<RHS, MAX_THREADS, 1, false, true, LIB_TABLE, false, false>
                     : &fused_network_kernel<RHS, MAX_THREADS, 1, false, false, LIB_TABLE, false, false>;
        return 0;
    case LATENCY_BUILD:
        if (!one) return (int)cudaErrorInvalidValue;
        *out = probe ? &fused_network_kernel<RHS, MAX_THREADS, 1, true, true, LIB_TABLE, false, false>
                     : &fused_network_kernel<RHS, MAX_THREADS, 1, true, false, LIB_TABLE, false, false>;
        return 0;
    case RESIDENCY_BUILD:
        if (!one) return (int)cudaErrorInvalidValue;
        *out = threads_for(slots) <= 192 ? &fused_network_kernel<RHS, 192, 2, true, false, LIB_TABLE, false, false>
                                         : &fused_network_kernel<RHS, MAX_THREADS, 2, true, false, LIB_TABLE, false, false>;
        return 0;
    case SCRATCH_BUILD:
        if (!probe) {
            *out = &fused_network_kernel<RHS, MAX_THREADS, 1, false, false, LIB_TABLE, true, false>;
            return 0;
        }
        if constexpr (!LIB_TABLE) {
            *out = &fused_network_kernel<RHS, MAX_THREADS, 1, false, true, false, true, false>;
            return 0;
        }
        return (int)cudaErrorInvalidValue;
    case BRACKET_BUILD:
        if constexpr (LIB_TABLE) {
            if (!one) return (int)cudaErrorInvalidValue;
            if (threads_for(slots) <= 192)
                *out = probe ? &fused_network_kernel<RHS, 192, BRACKET_MINB, true, true, true, false, false, true>
                             : &fused_network_kernel<RHS, 192, BRACKET_MINB, true, false, true, false, false, true>;
            else
                *out = probe ? &fused_network_kernel<RHS, MAX_THREADS, BRACKET_MINB, true, true, true, false, false, true>
                             : &fused_network_kernel<RHS, MAX_THREADS, BRACKET_MINB, true, false, true, false, false, true>;
            return 0;
        }
        return (int)cudaErrorInvalidValue;
    case LEAN_BUILD:
        if constexpr (LIB_TABLE) {
            if (!one) return (int)cudaErrorInvalidValue;
            *out = probe ? &fused_network_kernel<RHS, MAX_THREADS, 1, true, true, true, false, false, true, true>
                         : &fused_network_kernel<RHS, MAX_THREADS, 1, true, false, true, false, false, true, true>;
            return 0;
        }
        return (int)cudaErrorInvalidValue;
    case LEAN_SIDE_BUILD:   // (plan_of refuses a network lean_side does not take)
        if constexpr (LIB_TABLE) {
            if (!one) return (int)cudaErrorInvalidValue;
            *out = probe ? &fused_network_kernel<RHS, MAX_THREADS, 1, true, true, true, false, false, true, true, true>
                         : &fused_network_kernel<RHS, MAX_THREADS, 1, true, false, true, false, false, true, true, true>;
            return 0;
        }
        return (int)cudaErrorInvalidValue;
    case CLUSTER_BUILD:
        if (pair) {
            if (slots > PAIR_THREADS) return (int)cudaErrorInvalidValue;
            *out = &fused_network_kernel<RHS, PAIR_THREADS, 2, true, false, LIB_TABLE, false, true>;
            return 0;
        }
        if (!probe) {
            *out = one ? &fused_network_kernel<RHS, MAX_THREADS, 1, true, false, LIB_TABLE, false, true>
                       : &fused_network_kernel<RHS, MAX_THREADS, 1, false, false, LIB_TABLE, false, true>;
            return 0;
        }
        if constexpr (!LIB_TABLE) {
            *out = one ? &fused_network_kernel<RHS, MAX_THREADS, 1, true, true, false, false, true>
                       : &fused_network_kernel<RHS, MAX_THREADS, 1, false, true, false, false, true>;
            return 0;
        }
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaErrorInvalidValue;
}

int pick_build(int build, int slots, int rhs, bool probe, bool pair, NetKernel* out) {
    if (rhs == 2) return pick_rhs<2>(build, slots, probe, pair, out);
    if (rhs == 3) return pick_rhs<3>(build, slots, probe, pair, out);
    return (int)cudaErrorInvalidValue;
}

// What a launch runs: the kernel, the threads and dynamic shared memory of a
// block (the slot arrays too, except in the SCRATCH build; a rank's in the
// CLUSTER build) and, in the CLUSTER build, the blocks of a cluster and its
// form.
struct Plan {
    NetKernel fn = nullptr;
    int threads = 0, blocks = 1;
    bool pair = false;
    size_t smem = 0;
};

// The plan of a build for a network of `slots` slots.  cluster (CLUSTER
// build): its blocks, 2-MAX_CLUSTER (cudaErrorInvalidClusterSize otherwise),
// plus CLUSTER_PAIR for the two-blocks-an-SM form.  The LEAN_SIDE build's
// block has the side warps beyond the slots' warps, for a network that
// lean_side takes.
int plan_of(int build, int cluster, bool probe, int slots, int B, int J, int rhs, Plan* p) {
    if (build == CLUSTER_BUILD) {
        p->blocks = cluster & ~CLUSTER_PAIR;
        p->pair = (cluster & CLUSTER_PAIR) != 0;
        if (p->blocks < 2 || p->blocks > MAX_CLUSTER) return (int)cudaErrorInvalidClusterSize;
    }
    const int per = rank_slots(slots, p->blocks);
    if (build == LEAN_SIDE_BUILD && !lean_side(per, B, J)) return (int)cudaErrorInvalidValue;
    const int rc = pick_build(build, per, rhs, probe, p->pair, &p->fn);
    p->threads = threads_for(per) + (build == LEAN_SIDE_BUILD ? SIDE_WARPS * 32 : 0);
    p->smem = build == BRACKET_BUILD || build == LEAN_BUILD || build == LEAN_SIDE_BUILD
        ? bracket_smem_bytes(per, B, J, rhs)
        : (build == SCRATCH_BUILD ? junction_doubles(B, J) : smem_doubles(per, B, J, rhs)) * sizeof(double);
    return rc;
}

// Whether a plan's block fits the dynamic shared memory a block may take on
// this device: the block's opt-in limit less the kernel's static shared
// memory.
int smem_fits(const Plan& p, bool* fits) {
    int dev, optin, rc;
    cudaFuncAttributes attr;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))) return rc;
    if ((rc = (int)cudaFuncGetAttributes(&attr, (const void*)p.fn))) return rc;
    *fits = p.smem <= (size_t)optin - attr.sharedSizeBytes;
    return 0;
}

// The kernel's attributes a launch of the plan needs: its dynamic shared
// memory and, above 8 blocks, a non-portable cluster size.  A block beyond
// the card's shared memory is refused here (cudaErrorInvalidValue).
int prepare(const Plan& p) {
    cudaError_t e = cudaFuncSetAttribute((const void*)p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (e == cudaSuccess && p.blocks > 8)
        e = cudaFuncSetAttribute((const void*)p.fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    return (int)e;
}

// A launch configuration of the plan on `grid` blocks; attr receives the
// cluster dimension of the CLUSTER build.
cudaLaunchConfig_t config_of(const Plan& p, int grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3(p.threads);
    cfg.dynamicSmemBytes = p.smem;
    cfg.stream = stream;
    if (p.blocks > 1) {
        attr->id = cudaLaunchAttributeClusterDimension;
        attr->val.clusterDim.x = p.blocks;
        attr->val.clusterDim.y = 1;
        attr->val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    return cfg;
}

// blocks of a plan the occupancy calculator puts on one SM
int resident_blocks(const Plan& p, int* blocks) {
    const int rc = prepare(p);
    if (rc) return rc;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, (const void*)p.fn, p.threads, p.smem);
}

// clusters of a CLUSTER plan the card holds at once
int active_clusters(const Plan& p, int* clusters) {
    const int rc = prepare(p);
    if (rc) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of(p, p.blocks, nullptr, &attr);
    return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)p.fn, &cfg);
}

// The cluster the CLUSTER build takes for a network: the fewest blocks (at
// least 2) at which each rank holds at most MAX_THREADS slots, one slot a
// thread — or, if that takes more than MAX_CLUSTER, MAX_CLUSTER blocks of the
// loop form —, taking a block more while a rank's slot arrays do not fit a
// block's shared memory or the card cannot schedule the cluster
// (cudaOccupancyMaxActiveClusters).  0: no cluster holds the network.
// clusters_at_once (if given): how many of the chosen cluster the card holds
// at once.
int choose_cluster(int slots, int B, int J, int rhs, int* cluster, int* clusters_at_once = nullptr) {
    *cluster = 0;
    const int first = (slots + MAX_THREADS - 1) / MAX_THREADS;
    for (int cl = first < 2 ? 2 : (first > MAX_CLUSTER ? MAX_CLUSTER : first); cl <= MAX_CLUSTER; ++cl) {
        Plan p;
        bool fits;
        int rc, clusters;
        if ((rc = plan_of(CLUSTER_BUILD, cl, false, slots, B, J, rhs, &p))) return rc;
        if ((rc = smem_fits(p, &fits))) return rc;
        if (!fits) continue;
        if ((rc = active_clusters(p, &clusters))) return rc;
        if (clusters >= 1) {
            *cluster = cl;
            if (clusters_at_once) *clusters_at_once = clusters;
            return 0;
        }
    }
    return 0;
}

// The build a launch of n_members networks takes.  A network whose slot
// arrays do not fit one block's shared memory takes the CLUSTER build while
// a cluster's shared memory holds them and the card holds the batch in one
// wave of clusters, else the SCRATCH build; one with more slots than threads
// the loop build.  Else the latency build runs every batch the card holds at
// once in it; a larger batch takes the residency build when that holds more
// members.  A network with table branches chooses the same way among its
// TABLE builds, the BRACKET build where the residency build would run, and
// where the latency build would: the LEAN_SIDE build where lean_side takes
// the network, each member has an SM of its own and no external end has a
// lumped storage (storage), else the LEAN build where the card holds the
// batch at once in it too.  Each beat the latency build in turns there; a
// storage's end row (its bisection) outlasts the cells, so there the side
// warps only slowed the sweeps (PERF.md).
int choose_build(int n_members, int slots, int B, int J, int rhs, bool storage, int* build) {
    Plan loop;
    bool fits;
    int rc;
    if ((rc = plan_of(LOOP_BUILD, 0, false, slots, B, J, rhs, &loop)) || (rc = smem_fits(loop, &fits))) return rc;
    if (!fits) {
        int cluster, clusters = 0;
        if ((rc = choose_cluster(slots, B, J, rhs, &cluster, &clusters))) return rc;
        *build = cluster && n_members <= clusters ? CLUSTER_BUILD : SCRATCH_BUILD;
        return 0;
    }
    *build = slots <= MAX_THREADS ? LATENCY_BUILD : LOOP_BUILD;
    if (*build == LOOP_BUILD) return 0;
    int dev, sms, fast_bps, res_bps;
    Plan fast, res;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
    // within one wave of the latency build, a network with table branches:
    // the LEAN_SIDE or the LEAN build where its block fits shared memory and
    // the card holds the batch at once in it
    auto lean = [&]() {
        if constexpr (LIB_TABLE) {
            const int id = n_members <= sms && !storage && lean_side(slots, B, J) ? LEAN_SIDE_BUILD : LEAN_BUILD;
            Plan p;
            int bps = 1, rc2;
            if ((rc2 = plan_of(id, 0, false, slots, B, J, rhs, &p)) || (rc2 = smem_fits(p, &fits))) return rc2;
            if (fits && n_members > sms && (rc2 = resident_blocks(p, &bps))) return rc2;
            if (fits && n_members <= bps * sms) *build = id;
        }
        return 0;
    };
    if (n_members <= sms) return lean();
    if ((rc = plan_of(*build, 0, false, slots, B, J, rhs, &fast))) return rc;
    if ((rc = resident_blocks(fast, &fast_bps))) return rc;
    if (n_members <= fast_bps * sms) return lean();
    // past one wave of the latency build: the residency build, and for a
    // network with table branches the bracket build
    const int many = LIB_TABLE ? BRACKET_BUILD : RESIDENCY_BUILD;
    if ((rc = plan_of(many, 0, false, slots, B, J, rhs, &res)) || (rc = smem_fits(res, &fits))) return rc;
    if (!fits) return 0;
    if ((rc = resident_blocks(res, &res_bps))) return rc;
    if (res_bps > fast_bps) *build = many;
    return 0;
}

// The cluster a CLUSTER launch takes: (0) the C entry's choice,
// cudaErrorInvalidValue when no cluster holds the network; or `cluster`,
// refused when its size is out of range (cudaErrorInvalidClusterSize), its
// form does not take the network or a rank's block exceeds shared memory
// (cudaErrorInvalidValue), or the card cannot hold one such cluster at once
// (cudaErrorLaunchOutOfResources).
int cluster_of(int cluster, int slots, int B, int J, int rhs, int* out) {
    int rc, clusters;
    bool fits;
    Plan p;
    *out = cluster;
    if (cluster == 0) {
        if ((rc = choose_cluster(slots, B, J, rhs, out))) return rc;
        return *out == 0 ? (int)cudaErrorInvalidValue : 0;
    }
    if ((rc = plan_of(CLUSTER_BUILD, cluster, false, slots, B, J, rhs, &p))) return rc;
    if ((rc = smem_fits(p, &fits))) return rc;
    if (!fits) return (int)cudaErrorInvalidValue;
    if ((rc = active_clusters(p, &clusters))) return rc;
    return clusters < 1 ? (int)cudaErrorLaunchOutOfResources : 0;
}

// The grid of a launch: a block a member; for the SCRATCH build as many
// blocks as the card holds at once, at most one a member (each with its own
// scratch of slot_doubles(slots, rhs)); for the CLUSTER build as many
// clusters as the card holds at once, at most one a member
// (cudaErrorLaunchOutOfResources when it holds none).
int grid_of(const Plan& p, int build, int n_members, int* grid) {
    *grid = n_members;
    int rc, dev, sms, bps, clusters;
    if (build == SCRATCH_BUILD) {
        if ((rc = (int)cudaGetDevice(&dev))) return rc;
        if ((rc = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev))) return rc;
        if ((rc = resident_blocks(p, &bps))) return rc;
        if (bps < 1) return (int)cudaErrorInvalidConfiguration;
        if (bps * sms < n_members) *grid = bps * sms;
    } else if (build == CLUSTER_BUILD) {
        if ((rc = active_clusters(p, &clusters))) return rc;
        if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
        *grid = (clusters < n_members ? clusters : n_members) * p.blocks;
    }
    return 0;
}

// The plan and grid of a launch (cluster: as flowsim_fused_network takes it),
// with the kernel's attributes set.
int plan_launch(int build, int cluster, bool probe, int n_members, int slots, int B, int J, int rhs, Plan* p,
                int* grid) {
    int rc;
    bool fits;
    if (build == CLUSTER_BUILD && (rc = cluster_of(cluster, slots, B, J, rhs, &cluster))) return rc;
    if ((rc = plan_of(build, cluster, probe, slots, B, J, rhs, p))) return rc;
    if ((rc = smem_fits(*p, &fits))) return rc;
    if (!fits) return (int)cudaErrorInvalidValue;
    if ((rc = prepare(*p))) return rc;
    return grid_of(*p, build, n_members, grid);
}

int launch(int build, int cluster, bool probe, const double* geo, const double* h0, const double* Q0,
           const double* ser, const double* par, const double* qlat, const double* stor, const double* stab,
           long long stab_stride, const double* Y0, const int* bint, const double* jpar, const double* jtab,
           const int* tab_branch, const double* tab, double* depth, double* flow, double* Y, int* iters,
           double* err, int* conv, double* stage, double* gate, long long* probe_out, double* scratch,
           int n_members, int B, int n_max, int J, int nt, int max_iter, int rhs, int qlat_mode, int tab_m,
           cudaStream_t stream) {
    int rc, grid;
    Plan p;
    if (build == SCRATCH_BUILD && scratch == nullptr) return (int)cudaErrorInvalidValue;
    if ((rc = plan_launch(build, cluster, probe, n_members, B * n_max, B, J, rhs, &p, &grid))) return rc;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = config_of(p, grid, stream, &attr);
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, p.fn, geo, h0, Q0, ser, par, qlat, stor, stab, stab_stride, Y0, bint, jpar, jtab, depth, flow, Y,
        iters, err, conv, stage, gate, probe_out, B, n_max, J, nt, max_iter, pcr::n_sweeps(n_max), qlat_mode,
        tab_branch, tab, tab_m, n_members, scratch);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

int check_args(int n_members, int B, int n_max, int J, int nt, int qlat_mode, const void* qlat,
               const void* stage, const void* stor, const void* stab, const void* jtab, const void* tab_branch,
               const void* tab, int tab_m) {
    if (n_members <= 0 || B <= 0 || n_max <= 1 || J <= 0 || nt <= 0) return (int)cudaErrorInvalidValue;
    if (qlat_mode < QLAT_NONE || qlat_mode > QLAT_LEVELS) return (int)cudaErrorInvalidValue;
    if ((qlat_mode != QLAT_NONE) != (qlat != nullptr)) return (int)cudaErrorInvalidValue;
    if (stage == nullptr || stor == nullptr || stab == nullptr || jtab == nullptr) return (int)cudaErrorInvalidValue;
    // tables go to the library of the TABLE builds, and only there
    if (tab_m == 1 || tab_m < 0 || (tab_m != 0) != LIB_TABLE || (tab_m != 0) != (tab != nullptr)
        || (tab_m != 0) != (tab_branch != nullptr))
        return (int)cudaErrorInvalidValue;
    return 0;
}

}  // namespace

extern "C" int flowsim_fused_network_branch_ints() { return BI_COUNT; }
extern "C" int flowsim_fused_network_junction_params() { return JP_COUNT; }
extern "C" int flowsim_fused_network_probe_phases() { return PH_COUNT; }
extern "C" int flowsim_fused_network_assembly_parts() { return AP_COUNT; }
extern "C" int flowsim_fused_network_tables() { return TAB_COUNT; }
// dynamic shared memory of one block of the shared-memory builds, in bytes
// (of one rank of the CLUSTER build, with slots its rank_slots)
extern "C" long long flowsim_fused_network_smem_bytes(int slots, int B, int J, int rhs) {
    return (long long)(smem_doubles(slots, B, J, rhs) * sizeof(double));
}
// the SCRATCH build's scratch of one block, in bytes: the slot arrays
extern "C" long long flowsim_fused_network_scratch_bytes(int slots, int rhs) {
    return (long long)(slot_doubles(slots, rhs) * sizeof(double));
}

#define FLOWSIM_NET_ARGS (const double*)geo, (const double*)h0, (const double*)Q0, (const double*)ser, \
        (const double*)par, (const double*)qlat, (const double*)stor, (const double*)stab, stab_stride, \
        (const double*)Y0, (const int*)bint, (const double*)jpar, (const double*)jtab, (const int*)tab_branch, \
        (const double*)tab, \
        (double*)depth, (double*)flow, (double*)Y, (int*)iters, (double*)err, (int*)conv, (double*)stage, \
        (double*)gate

// One block per member (the SCRATCH build: a block per member up to the
// blocks the card holds at once; the CLUSTER build: a cluster per member up
// to the clusters it holds at once; grid_of): n_members = 1 is
// fused_simulate_network, M is fused_simulate_network_batched.  Every
// per-member array carries the leading
// member axis (the storage tables only when stab_stride != 0); bint, jpar,
// jtab and tab are shared.  stage [M, nt, B, 2] is filled with NaN by the
// caller.  tab_m: 0 for a network of trapezoid branches (tab and tab_branch
// null), else the depth samples M of every table branch's tables, tab [T, 7,
// Nmax, M], and tab_branch [B] each branch's index among them (-1: trapezoid).
// build: 0-7 (5-7 in the table library only); the wrappers pass what
// flowsim_fused_network_chosen_build answers, a forced build is a test hook
// (chip_smoke.py times the builds against each other and holds them to the
// same bits).  cluster (build 4): 0 for the C entry's cluster
// (flowsim_fused_network_cluster), or a forced one, a test hook: its blocks
// (2-16), plus 256 for the two-blocks-an-SM form.  scratch: null, or for
// the SCRATCH build grid x
// flowsim_fused_network_scratch_bytes of device memory (grid:
// flowsim_fused_network_grid).
extern "C" int flowsim_fused_network(const void* geo, const void* h0, const void* Q0, const void* ser,
                                     const void* par, const void* qlat, const void* stor, const void* stab,
                                     long long stab_stride, const void* Y0, const void* bint,
                                     const void* jpar, const void* jtab, const void* tab_branch, const void* tab,
                                     void* depth, void* flow, void* Y, void* iters, void* err, void* conv,
                                     void* stage, void* gate, void* scratch, int n_members, int B, int n_max, int J,
                                     int nt, int max_iter, int rhs, int qlat_mode, int tab_m, int build,
                                     int cluster, void* stream) {
    const int rc = check_args(n_members, B, n_max, J, nt, qlat_mode, qlat, stage, stor, stab, jtab, tab_branch, tab,
                              tab_m);
    if (rc) return rc;
    return launch(build, cluster, false, FLOWSIM_NET_ARGS, nullptr, (double*)scratch, n_members, B, n_max, J, nt,
                  max_iter, rhs, qlat_mode, tab_m, (cudaStream_t)stream);
}

// The probe build of the loop (build 0), latency (1), scratch (3), cluster
// (4, not its two-blocks-an-SM form; 3 and 4 in the trapezoid library),
// bracket (5) or lean (6, 7; 5-7 in the table library) form:
// the same launch, and the cycles of each phase of thread 0 of block 0 (the
// first cluster's rank 0) summed over the run into probe [PH_COUNT], then
// the parts of its assembly phase, [AP_COUNT] (device memory); clock_khz
// receives the SM clock rate the cycles count at (cudaDevAttrClockRate).
extern "C" int flowsim_fused_network_probe(const void* geo, const void* h0, const void* Q0, const void* ser,
                                           const void* par, const void* qlat, const void* stor, const void* stab,
                                           long long stab_stride, const void* Y0, const void* bint,
                                           const void* jpar, const void* jtab, const void* tab_branch,
                                           const void* tab, void* depth, void* flow, void* Y, void* iters,
                                           void* err, void* conv, void* stage, void* gate, void* scratch,
                                           void* probe, int* clock_khz, int n_members, int B, int n_max, int J,
                                           int nt, int max_iter, int rhs, int qlat_mode, int tab_m, int build,
                                           int cluster, void* stream) {
    int rc = check_args(n_members, B, n_max, J, nt, qlat_mode, qlat, stage, stor, stab, jtab, tab_branch, tab,
                        tab_m);
    if (rc) return rc;
    if (probe == nullptr || clock_khz == nullptr) return (int)cudaErrorInvalidValue;
    int dev;
    if ((rc = (int)cudaGetDevice(&dev))) return rc;
    if ((rc = (int)cudaDeviceGetAttribute(clock_khz, cudaDevAttrClockRate, dev))) return rc;
    return launch(build, cluster, true, FLOWSIM_NET_ARGS, (long long*)probe, (double*)scratch, n_members, B, n_max,
                  J, nt, max_iter, rhs, qlat_mode, tab_m, (cudaStream_t)stream);
}
#undef FLOWSIM_NET_ARGS

// dynamic shared memory of one block of the BRACKET and LEAN builds, in bytes
extern "C" long long flowsim_fused_network_bracket_smem_bytes(int slots, int B, int J, int rhs) {
    return (long long)bracket_smem_bytes(slots, B, J, rhs);
}

// The build flowsim_fused_network takes for n_members members (build -1);
// storage: whether an external end has a lumped storage.
extern "C" int flowsim_fused_network_chosen_build(int n_members, int slots, int B, int J, int rhs, int storage,
                                                  int* build) {
    if (n_members <= 0 || slots <= 0 || B <= 0 || J <= 0 || build == nullptr) return (int)cudaErrorInvalidValue;
    return choose_build(n_members, slots, B, J, rhs, storage != 0, build);
}

// The cluster the CLUSTER build launches with `cluster` (0: the C entry's
// choice, the fewest blocks at one slot a thread): its blocks, plus 256 for
// the two-blocks-an-SM form.
extern "C" int flowsim_fused_network_cluster(int slots, int B, int J, int rhs, int cluster, int* out) {
    if (slots <= 0 || B <= 0 || J <= 0 || out == nullptr) return (int)cudaErrorInvalidValue;
    return cluster_of(cluster, slots, B, J, rhs, out);
}

// Resident blocks per SM of a build (cluster: as flowsim_fused_network takes
// it) at this network's block size and shared memory, from the CUDA
// occupancy calculator.
extern "C" int flowsim_fused_network_resident_blocks(int slots, int B, int J, int rhs, int build, int cluster,
                                                     int* blocks) {
    if (slots <= 0 || B <= 0 || J <= 0 || blocks == nullptr) return (int)cudaErrorInvalidValue;
    int rc;
    Plan p;
    if (build == CLUSTER_BUILD && (rc = cluster_of(cluster, slots, B, J, rhs, &cluster))) return rc;
    if ((rc = plan_of(build, cluster, false, slots, B, J, rhs, &p))) return rc;
    return resident_blocks(p, blocks);
}

// The grid flowsim_fused_network launches for n_members members in a build
// (0-4; cluster as it takes it): n_members, for the SCRATCH build at most the
// blocks the card holds at once — the blocks whose scratch the caller
// allocates —, for the CLUSTER build the blocks of at most the clusters it
// holds at once.
extern "C" int flowsim_fused_network_grid(int n_members, int slots, int B, int J, int rhs, int build, int cluster,
                                          int* grid) {
    if (n_members <= 0 || slots <= 0 || B <= 0 || J <= 0 || build < 0 || grid == nullptr)
        return (int)cudaErrorInvalidValue;
    Plan p;
    return plan_launch(build, cluster, false, n_members, slots, B, J, rhs, &p, grid);
}
