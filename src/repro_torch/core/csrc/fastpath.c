
#include <stdint.h>
#include <string.h>

/* BFS from src over padded neighbour table nbr[n*kmax] (pad < 0), skipping
   edges (sa[t], sb[t]) and additionally traversing extra edges (xa[t], xb[t]).
   row[] gets hop distances, sentinel n for unreachable. */
static inline int is_endpoint(int u, const int32_t* ea, const int32_t* eb, int ne)
{
    for (int t = 0; t < ne; t++)
        if (u == ea[t] || u == eb[t]) return 1;
    return 0;
}

static void bfs_one(int n, int kmax, const int32_t* nbr,
                    const int32_t* sa, const int32_t* sb, int nskip,
                    const int32_t* xa, const int32_t* xb, int nextra,
                    int src, int32_t* row, int32_t* queue)
{
    for (int i = 0; i < n; i++) row[i] = n;
    row[src] = 0;
    int head = 0, tail = 0;
    queue[tail++] = src;
    while (head < tail) {
        int u = queue[head++];
        int32_t du = row[u];
        const int32_t* nb = nbr + (size_t)u * kmax;
        /* removed/added edges are incident only to their endpoints: the
           filter loops are needed only when u is one of those vertices */
        int ue = (nskip && is_endpoint(u, sa, sb, nskip)) ||
                 (nextra && is_endpoint(u, xa, xb, nextra));
        if (!ue) {
            for (int j = 0; j < kmax; j++) {
                int v = nb[j];
                if (v >= 0 && row[v] == n) { row[v] = du + 1; queue[tail++] = v; }
            }
            continue;
        }
        for (int j = 0; j < kmax; j++) {
            int v = nb[j];
            if (v < 0) continue;
            int skip = 0;
            for (int t = 0; t < nskip; t++)
                if ((u == sa[t] && v == sb[t]) || (u == sb[t] && v == sa[t])) { skip = 1; break; }
            if (skip) continue;
            if (row[v] == n) { row[v] = du + 1; queue[tail++] = v; }
        }
        for (int t = 0; t < nextra; t++) {
            int v = -1;
            if (u == xa[t]) v = xb[t];
            else if (u == xb[t]) v = xa[t];
            if (v >= 0 && row[v] == n) { row[v] = du + 1; queue[tail++] = v; }
        }
    }
}

/* Hop distances from sources 0..nsrc-1 into out[nsrc*n] (nsrc == n gives
   all-pairs; nsrc < n serves the row-restricted symmetric evaluator).
   queue: scratch of n ints. */
void apsp_rows(int n, int kmax, int nsrc, const int32_t* nbr, int32_t* out, int32_t* queue)
{
    for (int s = 0; s < nsrc; s++)
        bfs_one(n, kmax, nbr, 0, 0, 0, 0, 0, 0, s, out + (size_t)s * n, queue);
}

/* npar[s*n+x] = #neighbours w of x with dist[s*n+w] + 1 == dist[s*n+x],
   for source rows s = 0..nsrc-1. */
void parent_counts(int n, int kmax, int nsrc, const int32_t* nbr, const int32_t* dist, int16_t* npar)
{
    for (int s = 0; s < nsrc; s++) {
        const int32_t* ds = dist + (size_t)s * n;
        int16_t* ps = npar + (size_t)s * n;
        for (int x = 0; x < n; x++) {
            int32_t dx = ds[x];
            const int32_t* nb = nbr + (size_t)x * kmax;
            int c = 0;
            for (int j = 0; j < kmax; j++) {
                int w = nb[j];
                if (w >= 0 && ds[w] + 1 == dx) c++;
            }
            ps[x] = (int16_t)c;
        }
    }
}

static inline int edge_in(int x, int y, const int32_t* ea, const int32_t* eb, int ne)
{
    for (int t = 0; t < ne; t++)
        if ((x == ea[t] && y == eb[t]) || (x == eb[t] && y == ea[t])) return 1;
    return 0;
}

/* Ramalingam-Reps style repair of one source row after deleting the edges
   (ra[t], rb[t]): phase 1 cascades sole-parent invalidations from the
   endpoints (touching only damaged vertices), phase 2 Bellman-raises the
   invalidated set against the valid boundary.  row holds pre-removal
   distances in, exact post-removal distances out.  Returns #invalidated. */
/* #parents of y w.r.t. the distances in row (on-the-fly variant used when no
   maintained npar matrix is available). */
static inline int16_t count_parents(int n, int kmax, const int32_t* nbr,
                                    const int32_t* row, int y)
{
    const int32_t* nb = nbr + (size_t)y * kmax;
    int32_t dy = row[y];
    int16_t c = 0;
    for (int j = 0; j < kmax; j++) {
        int w = nb[j];
        if (w >= 0 && row[w] + 1 == dy) c++;
    }
    return c;
}

/* pc/state are epoch-stamped (stamp[y] == gen means initialised for this
   call): no per-source memcpy/memset, O(touched) setup instead of O(n).
   npar_row may be NULL -> counts are derived from the row itself. */
static inline void pc_touch(int n, int kmax, const int32_t* nbr, int y,
                            const int16_t* npar_row, const int32_t* row,
                            int16_t* pc, unsigned char* state,
                            int32_t* stamp, int32_t gen)
{
    if (stamp[y] != gen) {
        stamp[y] = gen;
        pc[y] = npar_row ? npar_row[y] : count_parents(n, kmax, nbr, row, y);
        state[y] = 0;
    }
}

static int cascade_repair(int n, int kmax, const int32_t* nbr,
                          const int16_t* npar_row, int32_t* row,
                          const int32_t* ra, const int32_t* rb, int nrem,
                          int32_t* queue, int16_t* pc, unsigned char* state,
                          int32_t* oldvals, int32_t* stamp, int32_t gen)
{
    int tail = 0;
    for (int t = 0; t < nrem; t++) {
        int a = ra[t], b = rb[t];
        pc_touch(n, kmax, nbr, a, npar_row, row, pc, state, stamp, gen);
        pc_touch(n, kmax, nbr, b, npar_row, row, pc, state, stamp, gen);
        if (row[a] + 1 == row[b] && !state[b] && --pc[b] == 0) { state[b] = 1; queue[tail++] = b; }
        if (row[b] + 1 == row[a] && !state[a] && --pc[a] == 0) { state[a] = 1; queue[tail++] = a; }
    }
    for (int head = 0; head < tail; head++) {
        int x = queue[head];
        const int32_t* nb = nbr + (size_t)x * kmax;
        int xe = is_endpoint(x, ra, rb, nrem);
        for (int j = 0; j < kmax; j++) {
            int y = nb[j];
            if (y < 0) continue;
            if (xe && edge_in(x, y, ra, rb, nrem)) continue;  /* counted at init */
            pc_touch(n, kmax, nbr, y, npar_row, row, pc, state, stamp, gen);
            if (state[y]) continue;
            if (row[x] + 1 == row[y] && --pc[y] == 0) { state[y] = 1; queue[tail++] = y; }
        }
    }
    int ninv = tail;
    for (int i = 0; i < ninv; i++) { oldvals[i] = row[queue[i]]; row[queue[i]] = n; }
    int changed = 1;
    while (changed) {
        changed = 0;
        for (int i = 0; i < ninv; i++) {
            int x = queue[i];
            const int32_t* nb = nbr + (size_t)x * kmax;
            int xe = is_endpoint(x, ra, rb, nrem);
            int32_t best = n;
            for (int j = 0; j < kmax; j++) {
                int y = nb[j];
                if (y < 0 || (xe && edge_in(x, y, ra, rb, nrem))) continue;
                int32_t cand = row[y] + 1;
                if (cand < best) best = cand;
            }
            if (best < row[x]) { row[x] = best; changed = 1; }
        }
    }
    return ninv;
}

/* Evaluate a 2-out / 2-in edge swap.
   rem = [a,b,c,d] removed edges (a,b),(c,d); add likewise.
   dist is the current matrix (sentinel n); npar its parent counts;
   base_total its sum (for incremental accounting on the delta path).
   Writes the exact post-swap matrix into newdist; total_out gets the exact
   new sum; max_out gets the exact new max, or -1 when want_max == 0 and
   the delta path proved the graph stayed connected (callers compute the
   diameter lazily on commit).  Returns the number of removal-affected
   sources, or -1 if the full-rebuild path ran.
   scratch: 8n int32, ZERO-INITIALISED at allocation (queue, aff, cols,
   oldvals, pc, state+affmask, stamp, gen counter). */
int32_t eval_swap(int n, int kmax, const int32_t* nbr,
                  const int32_t* dist, const int16_t* npar,
                  const int32_t* rem, const int32_t* add,
                  int force_full, double full_frac, int want_max,
                  int64_t base_total,
                  int32_t* newdist, int64_t* total_out, int32_t* max_out,
                  int32_t* scratch)
{
    int32_t* queue = scratch;
    int32_t* aff = scratch + n;
    int32_t* cols = scratch + 2 * n;
    int32_t* oldvals = scratch + 3 * n;
    int16_t* pc = (int16_t*)(scratch + 4 * n);
    unsigned char* state = (unsigned char*)(scratch + 5 * n);
    unsigned char* affmask = state + n;  /* n + n bytes <= 4n bytes of slot 5 */
    int32_t* stamp = scratch + 6 * n;
    int32_t* genp = scratch + 7 * n;
    const int32_t rem_a[2] = { rem[0], rem[2] }, rem_b[2] = { rem[1], rem[3] };
    const int32_t add_a[2] = { add[0], add[2] }, add_b[2] = { add[1], add[3] };
    int naff = 0;
    int full = force_full;
    if (!full) {
        for (int s = 0; s < n; s++) {
            const int32_t* ds = dist + (size_t)s * n;
            const int16_t* ps = npar ? npar + (size_t)s * n : 0;
            int hit = 0;
            for (int e = 0; e < 2 && !hit; e++) {
                int a = rem_a[e], b = rem_b[e];
                int32_t da = ds[a], db = ds[b];
                if (da + 1 == db &&
                    (ps ? ps[b] : count_parents(n, kmax, nbr, ds, b)) == 1) hit = 1;
                else if (db + 1 == da &&
                    (ps ? ps[a] : count_parents(n, kmax, nbr, ds, a)) == 1) hit = 1;
            }
            if (hit) aff[naff++] = s;
        }
        if (naff > full_frac * n) full = 1;
    }

    if (full) {
        for (int s = 0; s < n; s++)
            bfs_one(n, kmax, nbr, rem_a, rem_b, 2, add_a, add_b, 2,
                    s, newdist + (size_t)s * n, queue);
        int64_t tot = 0;
        int32_t mx = 0;
        const size_t nn = (size_t)n * n;
        for (size_t i = 0; i < nn; i++) {
            tot += newdist[i];
            if (newdist[i] > mx) mx = newdist[i];
        }
        *total_out = tot;
        *max_out = mx;
        return -1;
    }

    memcpy(newdist, dist, (size_t)n * n * sizeof(int32_t));
    memset(affmask, 0, (size_t)n);
    for (int i = 0; i < naff; i++) affmask[aff[i]] = 1;
    int64_t dr_all = 0, dr_affaff = 0;
    int has_sent = 0;
    /* phase 1: repair removal-affected rows on G minus removed edges */
    for (int i = 0; i < naff; i++) {
        int s = aff[i];
        int32_t* row = newdist + (size_t)s * n;
        if (++*genp <= 0) { memset(stamp, 0, (size_t)n * sizeof(int32_t)); *genp = 1; }
        int ninv = cascade_repair(n, kmax, nbr,
                                  npar ? npar + (size_t)s * n : 0, row,
                                  rem_a, rem_b, 2, queue, pc, state, oldvals,
                                  stamp, *genp);
        for (int t = 0; t < ninv; t++) {
            int x = queue[t];
            int64_t d = row[x] - oldvals[t];
            dr_all += d;
            if (affmask[x]) dr_affaff += d;
            if (row[x] >= n) has_sent = 1;
        }
    }
    for (int i = 0; i < naff; i++) {     /* mirror rows into columns */
        int s = aff[i];
        const int32_t* rs = newdist + (size_t)s * n;
        for (int x = 0; x < n; x++) newdist[(size_t)x * n + s] = rs[x];
    }
    int64_t tot = base_total + 2 * dr_all - dr_affaff;
    /* phase 2: exact unweighted edge-insert formula per added edge.  Rows x
       with |d(x,u) - d(x,v)| <= 1 provably cannot improve (triangle
       inequality through the closer endpoint) and are skipped. */
    for (int e = 0; e < 2; e++) {
        int u = add_a[e], v = add_b[e];
        int32_t* du = queue;   /* snapshot columns: formula needs pre-edge base */
        int32_t* dv = cols;
        for (int x = 0; x < n; x++) {
            du[x] = newdist[(size_t)x * n + u];
            dv[x] = newdist[(size_t)x * n + v];
        }
        for (int x = 0; x < n; x++) {
            int32_t dxu = du[x], dxv = dv[x];
            int32_t diff = dxu - dxv;
            if (diff <= 1 && diff >= -1) continue;
            int32_t* rowx = newdist + (size_t)x * n;
            /* branchless min-store (auto-vectorizes); account the total via
               row sums instead of per-element deltas */
            int64_t before = 0, after = 0;
            for (int y = 0; y < n; y++) before += rowx[y];
            for (int y = 0; y < n; y++) {
                int32_t c1 = dxu + 1 + dv[y];
                int32_t c2 = dxv + 1 + du[y];
                int32_t c = c1 < c2 ? c1 : c2;
                rowx[y] = c < rowx[y] ? c : rowx[y];
            }
            for (int y = 0; y < n; y++) after += rowx[y];
            tot += after - before;
        }
    }
    *total_out = tot;
    if (want_max || has_sent) {
        int64_t tot2 = 0;
        int32_t mx = 0;
        const size_t nn = (size_t)n * n;
        for (size_t i = 0; i < nn; i++) {
            tot2 += newdist[i];
            if (newdist[i] > mx) mx = newdist[i];
        }
        *total_out = tot2;
        *max_out = mx;
    } else {
        *max_out = -1;  /* connected; diameter deferred */
    }
    return naff;
}

/* Orbit-delta entry point: batched multi-edge swap evaluation on the
   row-restricted distance matrix of a rotationally symmetric graph.

   dist/newdist are s*n (source rows 0..s-1); the graph must be invariant
   under rotation by s before AND after the swap (the removed/added edge
   sets are unions of rotation orbits — the caller validates).  Removed
   edges are (ra[t], rb[t]) for t < nrem; ria/rib give, per edge, the slot
   of each endpoint in the unique-endpoint table rpts[nrp].  Added edges
   likewise (xa, xb, nadd) with unique endpoints apts[nap].

   Phase 1 is the exact batched lost-parent test + cascade repair of the
   affected rows on the graph minus the removed edges; phase 2 patches the
   insertions by a min-plus closure through the added-edge endpoints, whose
   full post-removal rows are rotations of representative rows (the
   post-removal graph is still symmetric).

   total_out gets the representative-row total (full total = fold * it);
   max_out the row max (== global diameter by symmetry).  Returns the
   number of affected rows, or -1 when the full-rebuild path ran.
   scratch: the evaluator's 8n zero-initialised int32 block (queue, pc,
   state, oldvals, stamp, gen — same layout as eval_swap).
   work: >= nap*(n + nap + 2) + nrp int32 (rolled endpoint rows, the
   endpoint closure matrix, two m-vectors, lost counters). */
int32_t eval_orbit_swap(int n, int kmax, int s, const int32_t* nbr,
                        const int32_t* dist, const int16_t* npar,
                        const int32_t* ra, const int32_t* rb, int nrem,
                        const int32_t* ria, const int32_t* rib,
                        const int32_t* rpts, int nrp,
                        const int32_t* xa, const int32_t* xb, int nadd,
                        const int32_t* apts, int nap,
                        int force_full, double full_frac,
                        int32_t* newdist, int64_t* total_out, int32_t* max_out,
                        int32_t* scratch, int32_t* work)
{
    int32_t* queue = scratch;
    int32_t* aff = scratch + n;
    int32_t* oldvals = scratch + 3 * n;
    int16_t* pc = (int16_t*)(scratch + 4 * n);
    unsigned char* state = (unsigned char*)(scratch + 5 * n);
    int32_t* stamp = scratch + 6 * n;
    int32_t* genp = scratch + 7 * n;
    int32_t* crows = work;                              /* nap * n  */
    int32_t* w = work + (size_t)nap * n;                /* nap * nap */
    int32_t* arow = w + (size_t)nap * nap;              /* nap */
    int32_t* tmp = arow + nap;                          /* nap */
    int32_t* lost = tmp + nap;                          /* nrp */

    const size_t sn = (size_t)s * n;
    int naff = 0;
    int full = force_full;
    if (!full) {
        for (int r = 0; r < s; r++) {
            const int32_t* ds = dist + (size_t)r * n;
            for (int i = 0; i < nrp; i++) lost[i] = 0;
            for (int t = 0; t < nrem; t++) {
                if (ds[ra[t]] + 1 == ds[rb[t]]) lost[rib[t]]++;
                if (ds[rb[t]] + 1 == ds[ra[t]]) lost[ria[t]]++;
            }
            const int16_t* ps = npar + (size_t)r * n;
            for (int i = 0; i < nrp; i++)
                if (lost[i] > 0 && lost[i] == ps[rpts[i]]) { aff[naff++] = r; break; }
        }
        if (naff > full_frac * s) full = 1;
    }

    if (full) {
        for (int r = 0; r < s; r++)
            bfs_one(n, kmax, nbr, ra, rb, nrem, xa, xb, nadd,
                    r, newdist + (size_t)r * n, queue);
        naff = -1;
    } else {
        memcpy(newdist, dist, sn * sizeof(int32_t));
        for (int i = 0; i < naff; i++) {
            int r = aff[i];
            int32_t* row = newdist + (size_t)r * n;
            if (++*genp <= 0) { memset(stamp, 0, (size_t)n * sizeof(int32_t)); *genp = 1; }
            cascade_repair(n, kmax, nbr, npar ? npar + (size_t)r * n : 0, row,
                           ra, rb, nrem, queue, pc, state, oldvals, stamp, *genp);
        }
        if (nadd) {
            /* rolled post-removal endpoint rows: crows[i][y] = d_rm(p_i, y)
               = d_rm(p_i mod s, (y - t) mod n) with t = p_i - p_i mod s */
            for (int i = 0; i < nap; i++) {
                int p = apts[i];
                int t = p - p % s;
                const int32_t* src = newdist + (size_t)(p % s) * n;
                int32_t* dst = crows + (size_t)i * n;
                for (int j = 0; j < n; j++) {
                    int y = j + t;
                    if (y >= n) y -= n;   /* t < n: one wrap suffices */
                    dst[y] = src[j];
                }
            }
            /* endpoint-to-endpoint closure, added edges as weight-1 links */
            for (int i = 0; i < nap; i++)
                for (int j = 0; j < nap; j++)
                    w[i * nap + j] = crows[(size_t)i * n + apts[j]];
            for (int t = 0; t < nadd; t++) {
                int iu = -1, iv = -1;
                for (int i = 0; i < nap; i++) {
                    if (apts[i] == xa[t]) iu = i;
                    if (apts[i] == xb[t]) iv = i;
                }
                if (w[iu * nap + iv] > 1) { w[iu * nap + iv] = 1; w[iv * nap + iu] = 1; }
            }
            for (int k = 0; k < nap; k++)
                for (int i = 0; i < nap; i++) {
                    int32_t wik = w[i * nap + k];
                    for (int j = 0; j < nap; j++) {
                        int32_t c = wik + w[k * nap + j];
                        if (c < w[i * nap + j]) w[i * nap + j] = c;
                    }
                }
            /* d'(r, y) = min(d_rm(r, y), min_j tmp[j] + crows[j][y]) with
               tmp[j] = min_i d_rm(r, p_i) + w(i, j) */
            for (int r = 0; r < s; r++) {
                int32_t* row = newdist + (size_t)r * n;
                for (int i = 0; i < nap; i++) arow[i] = row[apts[i]];
                for (int j = 0; j < nap; j++) {
                    int32_t best = arow[0] + w[j];
                    for (int i = 1; i < nap; i++) {
                        int32_t c = arow[i] + w[i * nap + j];
                        if (c < best) best = c;
                    }
                    tmp[j] = best;
                }
                for (int j = 0; j < nap; j++) {
                    int32_t tj = tmp[j];
                    if (tj >= n) continue;   /* sentinel-contaminated: no-op */
                    const int32_t* cj = crows + (size_t)j * n;
                    for (int y = 0; y < n; y++) {
                        int32_t c = tj + cj[y];
                        if (c < row[y]) row[y] = c;
                    }
                }
            }
        }
    }
    int64_t tot = 0;
    int32_t mx = 0;
    for (size_t i = 0; i < sn; i++) {
        tot += newdist[i];
        if (newdist[i] > mx) mx = newdist[i];
    }
    *total_out = tot;
    *max_out = mx;
    return naff;
}

/* ---------------------------------------------------------------------------
   Word-packed (bitset-frontier) batched BFS.

   Bits pack the SOURCE dimension: F[v] is an sw-word bitset whose bit j is
   set when source j's frontier currently contains vertex v (sw = ceil(nsrc /
   64) words, so the whole frontier/visited state for an N=8192 graph with
   1024 representative sources is ~1 MB per set).  One level advances ALL
   sources at once with word-parallel OR/AND-NOT sweeps:

       N[v]  = OR_{u in nbr(v)} F[u]        (gather over the neighbour table)
       newF  = N & ~V;  V |= newF           (AND-NOT against visited)

   which is O(n * k * sw) words per level for a k-regular graph — the n/64
   speedup over per-source queue BFS that makes the no-kernel polish tier
   fast, and the same sweep the numpy and JAX variants implement.  Distances
   are exact hop counts (sentinel n for unreachable), bit-identical to every
   other BFS in this file. */
void bitset_bfs_rows(int n, int kmax, int nsrc, const int32_t* srcs,
                     const int32_t* nbr, int32_t* dist,
                     uint64_t* F, uint64_t* V, uint64_t* N)
{
    int sw = (nsrc + 63) >> 6;
    size_t words = (size_t)n * sw;
    memset(F, 0, words * sizeof(uint64_t));
    memset(V, 0, words * sizeof(uint64_t));
    for (size_t i = 0; i < (size_t)nsrc * n; i++) dist[i] = n;
    for (int j = 0; j < nsrc; j++) {
        int v = srcs[j];
        uint64_t bit = 1ull << (j & 63);
        F[(size_t)v * sw + (j >> 6)] |= bit;
        V[(size_t)v * sw + (j >> 6)] |= bit;
        dist[(size_t)j * n + v] = 0;
    }
    int d = 0, changed = 1;
    while (changed) {
        changed = 0;
        d++;
        for (int v = 0; v < n; v++) {
            uint64_t* Nv = N + (size_t)v * sw;
            for (int w = 0; w < sw; w++) Nv[w] = 0;
            const int32_t* nb = nbr + (size_t)v * kmax;
            for (int j = 0; j < kmax; j++) {
                int u = nb[j];
                if (u < 0) continue;
                const uint64_t* Fu = F + (size_t)u * sw;
                for (int w = 0; w < sw; w++) Nv[w] |= Fu[w];
            }
        }
        for (int v = 0; v < n; v++) {
            uint64_t* Nv = N + (size_t)v * sw;
            uint64_t* Vv = V + (size_t)v * sw;
            for (int w = 0; w < sw; w++) {
                uint64_t nf = Nv[w] & ~Vv[w];
                Nv[w] = nf;          /* N doubles as the next frontier */
                if (!nf) continue;
                changed = 1;
                Vv[w] |= nf;
                do {
                    int b = __builtin_ctzll(nf);
                    dist[(size_t)(w * 64 + b) * n + v] = d;
                    nf &= nf - 1;
                } while (nf);
            }
        }
        { uint64_t* t = F; F = N; N = t; }
    }
}

#include <math.h>

static void rebuild_nbr_row(int n, int kmax, const unsigned char* adj, int32_t* nbr, int u)
{
    const unsigned char* row = adj + (size_t)u * n;
    int32_t* out = nbr + (size_t)u * kmax;
    int j = 0;
    for (int v = 0; v < n; v++)
        if (row[v]) out[j++] = v;
    for (; j < kmax; j++) out[j] = -1;
}

/* One chunk of the simulated-annealing inner loop, entirely in C.

   All randomness is pre-drawn by the caller (de1/de2 = chord indices,
   dorient = 0/1, du = uniform accept draws, one each per iteration), so a
   pure-python fallback consuming the same arrays follows a bit-identical
   trajectory.  State (dist/npar/nbr/adj/chords/t/cur/best) is updated in
   place; returns the number of iterations executed (< chunk_iters only on
   target hit).

   hist_io: [capacity, count]; improvements append (iter, total) pairs.
   stats_io: [accepted, n_delta, n_full, invalid] accumulated. */
int32_t sa_chunk(int n, int kmax,
                 int32_t* nbr, int32_t* dist, int16_t* npar,
                 unsigned char* adj, unsigned char* best_adj,
                 int32_t* chords, int32_t m_c,
                 int32_t chunk_iters, int32_t iter_base,
                 const int32_t* de1, const int32_t* de2,
                 const int32_t* dorient, const double* du,
                 double* t_io, double gamma, double full_frac,
                 int64_t* cur_total_io, int32_t* cur_diam_io,
                 int64_t* best_total_io, int32_t* best_diam_io,
                 int64_t target_total,
                 int32_t* hist_iters, int64_t* hist_totals, int32_t* hist_io,
                 int32_t* newdist, int32_t* scratch, int64_t* stats_io)
{
    const double norm = (double)n * (n - 1);
    double t = *t_io;
    int64_t cur_total = *cur_total_io;
    int32_t cur_diam = *cur_diam_io;
    int64_t best_total = *best_total_io;
    int32_t best_diam = *best_diam_io;
    const size_t nn = (size_t)n * n;
    int32_t* cur_dist = dist;      /* accepted state: buffers swap roles */
    int32_t* prop_dist = newdist;
    int32_t it = 0;
    for (; it < chunk_iters; it++) {
        double t_next = t * gamma;  /* seed semantics: decay before accept */
        int e1 = de1[it], e2 = de2[it];
        t = t_next;
        if (e1 == e2) { stats_io[3]++; continue; }
        int a = chords[2 * e1], b = chords[2 * e1 + 1];
        int c = chords[2 * e2], d = chords[2 * e2 + 1];
        if (a == c || a == d || b == c || b == d) { stats_io[3]++; continue; }
        int p1a, p1b, p2a, p2b;
        if (dorient[it]) { p1a = a; p1b = c; p2a = b; p2b = d; }
        else             { p1a = a; p1b = d; p2a = b; p2b = c; }
        if (adj[(size_t)p1a * n + p1b] || adj[(size_t)p2a * n + p2b]) { stats_io[3]++; continue; }
        int32_t rem[4] = { a, b, c, d };
        int32_t add[4] = { p1a, p1b, p2a, p2b };
        int64_t total;
        int32_t mx;
        int32_t naff = eval_swap(n, kmax, nbr, cur_dist, npar, rem, add,
                                 0, full_frac, 0, cur_total,
                                 prop_dist, &total, &mx, scratch);
        if (naff < 0) stats_io[2]++; else stats_io[1]++;
        if (mx >= n) continue;  /* disconnected: dm = +inf, always rejected */
        double dm = (double)(total - cur_total) / norm;
        if (!(dm < 0.0)) {
            double tt = t > 1e-12 ? t : 1e-12;
            if (!(du[it] < exp(-dm / tt))) continue;
        }
        /* commit: swap the distance buffers instead of copying 4n^2 bytes */
        { int32_t* tmp = cur_dist; cur_dist = prop_dist; prop_dist = tmp; }
        adj[(size_t)a * n + b] = adj[(size_t)b * n + a] = 0;
        adj[(size_t)c * n + d] = adj[(size_t)d * n + c] = 0;
        adj[(size_t)p1a * n + p1b] = adj[(size_t)p1b * n + p1a] = 1;
        adj[(size_t)p2a * n + p2b] = adj[(size_t)p2b * n + p2a] = 1;
        rebuild_nbr_row(n, kmax, adj, nbr, a);
        rebuild_nbr_row(n, kmax, adj, nbr, b);
        rebuild_nbr_row(n, kmax, adj, nbr, c);
        rebuild_nbr_row(n, kmax, adj, nbr, d);
        if (npar) parent_counts(n, kmax, n, nbr, cur_dist, npar);
        chords[2 * e1] = p1a; chords[2 * e1 + 1] = p1b;
        chords[2 * e2] = p2a; chords[2 * e2 + 1] = p2b;
        cur_total = total;
        cur_diam = 0;
        for (size_t i = 0; i < nn; i++)
            if (cur_dist[i] > cur_diam) cur_diam = cur_dist[i];
        stats_io[0]++;
        if (cur_total < best_total || (cur_total == best_total && cur_diam < best_diam)) {
            best_total = cur_total;
            best_diam = cur_diam;
            memcpy(best_adj, adj, nn);
            if (hist_io[1] < hist_io[0]) {
                hist_iters[hist_io[1]] = iter_base + it;
                hist_totals[hist_io[1]] = cur_total;
                hist_io[1]++;
            }
            if (target_total >= 0 && best_total <= target_total) { it++; break; }
        }
    }
    if (cur_dist != dist)  /* odd number of accepts: settle into caller's buffer */
        memcpy(dist, cur_dist, nn * sizeof(int32_t));
    *t_io = t;
    *cur_total_io = cur_total;
    *cur_diam_io = cur_diam;
    *best_total_io = best_total;
    *best_diam_io = best_diam;
    return it;
}
