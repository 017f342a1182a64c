// openhevc_tpu native host parse core.
//
// Slice-data parsing at native speed: CABAC engine + full syntax layer +
// MV derivation, emitting the same FrameSymbols arrays as the Python
// reference parser (bitstream/syntax.py, bitstream/mvs.py — which this file
// mirrors 1:1; the Python implementation remains the correctness mirror and
// both are cross-checked in tests). Normative constants come from
// tables.inc, generated from the Python tables.
//
// Build: make (g++ -O3 -shared); interface: plain C ABI via ctypes.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <array>
#include <atomic>
#include <chrono>
#include <memory>
#include <thread>
#include <vector>

#include "tables.inc"
#define CTX_STATE_BYTES (NUM_CONTEXTS + 4)

namespace {

// ---------------------------------------------------------------------------
// CABAC (spec-form engine; parity with bitstream/cabac.py)
// ---------------------------------------------------------------------------

enum { RBSP_PAD = 32 };   // zero padding after the stream (bit-cache refill)

// combined-state transition tables over the packed (p_state<<1 | mps) byte,
// derived from TRANS_MPS/TRANS_LPS (tables.inc) — fold the p_state==0 MPS
// flip into the table so decode_bin has no state-update branches
struct NextTables {
    uint8_t mps[128], lps[128];
    NextTables() {
        for (int s = 0; s < 128; s++) {
            int p = s >> 1, m = s & 1;
            mps[s] = (uint8_t)((TRANS_MPS[p] << 1) | m);
            lps[s] = (uint8_t)(p == 0 ? ((TRANS_LPS[0] << 1) | (1 - m))
                                      : ((TRANS_LPS[p] << 1) | m));
        }
    }
};
static const NextTables NEXT_TAB;
#define NEXT_MPS NEXT_TAB.mps
#define NEXT_LPS NEXT_TAB.lps

// precomputed inverse scans (position of (x,y) in scan order) — replaces
// the per-residual-call inverse-map construction and CG linear search
struct InvScans {
    uint8_t off4[3][16];      // [scan][y*4+x] -> pos within 4x4 sub-block
    uint8_t cg[3][4][64];     // [scan][log2(ncg)][y*8+x] -> sub-block pos
    InvScans() {
        const uint8_t* offs[3] = {SCAN4_DIAG, SCAN4_HORIZ, SCAN4_VERT};
        for (int s = 0; s < 3; s++)
            for (int i = 0; i < 16; i++)
                off4[s][offs[s][i * 2 + 1] * 4 + offs[s][i * 2]] =
                    (uint8_t)i;
        const uint8_t* cgs[3][4] = {
            {nullptr, SCANCG2_DIAG, SCANCG4_DIAG, SCANCG8_DIAG},
            {nullptr, SCANCG2_HORIZ, SCANCG4_HORIZ, SCANCG8_HORIZ},
            {nullptr, SCANCG2_VERT, SCANCG4_VERT, SCANCG8_VERT}};
        memset(cg, 0, sizeof(cg));
        for (int s = 0; s < 3; s++)
            for (int l = 1; l < 4; l++) {
                int n = 1 << l;
                for (int i = 0; i < n * n; i++)
                    cg[s][l][cgs[s][l][i * 2 + 1] * 8 + cgs[s][l][i * 2]] =
                        (uint8_t)i;
            }
    }
};
static const InvScans INV_SC;

// sig_coeff_flag context increments per (scan, map_row) in scan-position
// order: folds the off_scan position loads + SIG_CTX_MAP lookup out of
// the hottest bin loop in residual coding.
struct SigInc {
    uint8_t t[3][5 * 16];
    SigInc() {
        const uint8_t* offs[3] = {SCAN4_DIAG, SCAN4_HORIZ, SCAN4_VERT};
        for (int s = 0; s < 3; s++)
            for (int r = 0; r < 5; r++)
                for (int n = 0; n < 16; n++) {
                    int xc = offs[s][n * 2], yc = offs[s][n * 2 + 1];
                    t[s][r * 16 + n] =
                        SIG_CTX_MAP[r * 16 + yc * 4 + xc];
                }
    }
};
static const SigInc SIG_INC;
static inline const uint8_t* sig_inc_lut(int scan_idx) {
    return SIG_INC.t[scan_idx];
}

// --- phase profiling (OPENHEVC_PARSE_PROF=1; meaningful with
// parse_threads=1 — counters are plain globals). Cycle counters around
// the parse hot phases, read from Python via hevc_prof_read. ---------
static uint64_t prof_cyc[8];
static uint64_t prof_cnt[8];
static int prof_on = -1;
static inline bool prof_enabled() {
    if (prof_on < 0) {
        const char* e = getenv("OPENHEVC_PARSE_PROF");
        prof_on = (e && e[0] == '1') ? 1 : 0;
    }
    return prof_on == 1;
}
struct ProfScope {
    int i = -1;
    uint64_t t0 = 0;
    explicit ProfScope(int idx) {
        if (prof_enabled()) { i = idx; t0 = __builtin_ia32_rdtsc(); }
    }
    ~ProfScope() {
        if (i >= 0) {
            prof_cyc[i] += __builtin_ia32_rdtsc() - t0;
            prof_cnt[i]++;
        }
    }
};
extern "C" void hevc_prof_read(uint64_t* cyc8, uint64_t* cnt8) {
    memcpy(cyc8, prof_cyc, sizeof(prof_cyc));
    memcpy(cnt8, prof_cnt, sizeof(prof_cnt));
}
extern "C" void hevc_prof_reset() {
    memset(prof_cyc, 0, sizeof(prof_cyc));
    memset(prof_cnt, 0, sizeof(prof_cnt));
}

struct Cabac {
    // 64-bit bit-cache front end: `cache` holds the next `ncache` stream
    // bits in its MSBs (positions [bitpos, bitpos+ncache)); renorm pulls
    // whole shift counts with one lzcnt instead of bit-at-a-time reads.
    const uint8_t* data;     // ZERO-PADDED past the stream end (16 bytes,
                             // hevc_parse_slice copies into a padded
                             // buffer) so past-end bits read as 0 with no
                             // per-take masking
    int64_t nbits;
    int64_t pad_bytes;       // padded buffer length
    int64_t bitpos;          // logical bits consumed (drives substream
                             // boundaries via consumed_bytes())
    uint32_t range, offset;
    uint64_t cache;
    int ncache;

    inline void refill() {
        // append 4 bytes' worth of bits after the cached window
        int64_t next = bitpos + ncache;          // first uncached bit
        int64_t byte = next >> 3;
        uint32_t raw = 0;
        if (byte + 4 <= pad_bytes) {             // predicted-true guard
            memcpy(&raw, data + byte, 4);
            raw = __builtin_bswap32(raw);
        }
        cache |= ((uint64_t)raw << (32 + (next & 7))) >> ncache;
        ncache += 32 - (int)(next & 7);
    }
    inline uint32_t take(int n) {                // n in 1..24
        if (ncache < n) refill();
        uint32_t v = (uint32_t)(cache >> (64 - n));
        cache <<= n;
        ncache -= n;
        bitpos += n;
        return v;
    }
    inline int bit() { return (int)take(1); }

    void reinit(int64_t start_bit) {
        bitpos = start_bit;
        cache = 0;
        ncache = 0;
        range = 510;
        offset = take(9);
    }
    inline int decode_bin(uint8_t* __restrict ctx, int idx) {
        if (__builtin_expect(prof_on == 1, 0)) prof_cnt[6]++;
        // branchless regular bin: combined-state transition tables
        // (NEXT_MPS/NEXT_LPS over the packed (p_state<<1|mps) byte) and
        // cmov-style selects; the only branch left is the renorm, whose
        // take() refill the compiler keeps off the hot path
        uint32_t s = ctx[idx];
        uint32_t lps = LPS_RANGE[(s >> 1) * 4 + ((range >> 6) & 3)];
        uint32_t r2 = range - lps;
        uint32_t is_lps = (uint32_t)(offset >= r2);
        int bin_val = (int)((s ^ is_lps) & 1);
        offset -= r2 & (0u - is_lps);
        range = is_lps ? lps : r2;
        ctx[idx] = (uint8_t)(is_lps ? NEXT_LPS[s] : NEXT_MPS[s]);
        if (range < 256) {
            int sh = __builtin_clz(range) - 23;  // renorm shift, 1..7
            range <<= sh;
            offset = (offset << sh) | take(sh);
        }
        return bin_val;
    }
    inline int bypass() {
        offset = (offset << 1) | take(1);
        if (offset >= range) { offset -= range; return 1; }
        return 0;
    }
    inline uint32_t bypass_chunk(int n) {     // n in 1..16
        // k bypass bits == one step of long division: extend the offset
        // (the arithmetic-coder remainder, always < range) by k stream
        // bits; the k-bit quotient by `range` IS the decoded bit string
        uint64_t acc = ((uint64_t)offset << n) | take(n);
        uint32_t q = (uint32_t)(acc / range);
        offset = (uint32_t)(acc - (uint64_t)q * range);
        return q;
    }
    inline uint32_t bypass_bits(int n) {
        if (n <= 0) return 0;
        uint32_t v = 0;
        while (n > 16) { v = (v << 16) | bypass_chunk(16); n -= 16; }
        return (v << n) | bypass_chunk(n);
    }
    inline int terminate() {
        range -= 2;
        if (offset >= range) return 1;
        if (range < 256) { range <<= 1; offset = (offset << 1) | take(1); }
        return 0;
    }
    inline int64_t consumed_bytes() const { return (bitpos + 7) >> 3; }
};

// ---------------------------------------------------------------------------
// ABI structs (layouts mirrored in bitstream/native.py)
// ---------------------------------------------------------------------------
struct SliceParams {
    int32_t width, height, log2_ctb, log2_min_cb, log2_min_tb, log2_max_tb;
    int32_t max_trafo_depth_intra, max_trafo_depth_inter;
    int32_t bit_depth, chroma_format_idc;
    int32_t pcm_enabled, pcm_bd, pcm_bd_c, log2_min_pcm, log2_max_pcm;
    int32_t amp_enabled, strong_intra_smoothing, intra_smoothing_disabled;
    int32_t sign_data_hiding, cabac_init_present;
    int32_t cb_qp_offset, cr_qp_offset, slice_cb_qp_offset, slice_cr_qp_offset;
    int32_t transquant_bypass_enabled, transform_skip_enabled, log2_max_ts;
    int32_t constrained_intra_pred, log2_parallel_merge;
    int32_t implicit_rdpcm;
    int32_t slice_type, slice_qp, cabac_init_flag, max_merge_cand, mvd_l1_zero;
    int32_t num_ref0, num_ref1;
    int32_t ref_poc[2][16];
    int32_t ref_lt[2][16];
    int32_t cur_poc;
    int32_t sao_enabled, slice_sao_luma, slice_sao_chroma;
    int32_t data_start_byte;
    int32_t qp_bd_offset;
    int32_t tiles_enabled, num_tile_cols, num_tile_rows;
    int32_t entropy_coding_sync;
    // parallel substream entry (0 = serial byte-aligned continuation):
    // absolute rbsp byte offset of each WPP-row / tile substream
    int32_t num_substreams;
    int32_t ss_start[128];
    // TMVP (8.5.3.1.7/8; temporal_luma_motion_vector, hevc_mvs.c:227):
    // collocated picture POC + its reference lists' {poc: long-term}
    // map; the motion grids ride as separate hevc_parse_slice args
    int32_t temporal_mvp, colloc_from_l0, col_poc;
    int32_t n_col_lt;
    int32_t col_lt_poc[32];
    int32_t col_lt_flag[32];
    // cu_qp_delta (7.4.9.10; CU-tail QP derivation hevc.c:2489-2500,
    // get_qPy_pred hevc_filter.c:91)
    int32_t cu_qp_delta_enabled, diff_cu_qp_delta_depth;
    // multi-slice segments: first CTB (tile-scan), independent-slice
    // ordinal (prediction-region id), dependent-segment flag
    int32_t start_ts, slice_no, dependent;
    // RExt tool set (SPS range extension; python mirror syntax.py)
    int32_t ts_rotation, explicit_rdpcm, persistent_rice, cross_component;
    // explicit tile boundaries in CTBs (non-uniform spacing,
    // hevc_ps.c:2305-2341 derivation done host-side); 0 = derive
    // uniform boundaries internally
    int32_t n_col_bd_in, n_row_bd_in;
    int32_t col_bd_in[25], row_bd_in[25];
    // cu_chroma_qp_offset (RExt PPS offset lists, slice-level gate;
    // hevc.c:1247-1263, python mirror syntax.py:1003-1021)
    int32_t cu_chroma_qp_offset_enabled, diff_cu_chroma_qp_offset_depth;
    int32_t n_cqo_list;
    int32_t cqo_cb[6], cqo_cr[6];
    // per-decoder substream worker count (the "slice threads" knob,
    // openHevcWrapper.c:80-87); 0 = auto (hw concurrency / env)
    int32_t parse_threads;
};

struct Outputs {
    uint8_t *ipm, *pred_mode, *is_pcm, *tqb, *cbf_luma4, *bounds_v, *bounds_h;
    int8_t  *qp_y4;
    uint8_t *mv_pf;       // [h4*w4]
    int32_t *mv;          // [h4*w4*4] l0x,l0y,l1x,l1y
    int32_t *mv_poc;      // [h4*w4*2]
    int8_t  *mv_refidx;   // [h4*w4*2]
    int16_t *sao;         // [ctbs_h*ctbs_w*3*6]
    int32_t *cb_meta;     // [cb_cap*8]
    int16_t *cb_levels;   // [lvl_cap]
    int32_t *ij_meta;     // [ij_cap*6]
    uint8_t *ij_avail;    // [ij_cap*132]
    int32_t *pcm_meta;    // [pcm_cap*3]
    uint16_t*pcm_samples; // [pcm_arena_cap]
    int32_t *pb;          // [pb_cap*14]
    int32_t cb_cap, lvl_cap, ij_cap, pcm_cap, pcm_arena_cap, pb_cap;
    int32_t n_cb, n_ij, n_pcm, n_pb, lvl_used, pcm_used;
    int32_t error;
    // how the picture was parsed: substream workers (1 serial), 1 when
    // a threaded attempt failed and the serial re-parse gave the result,
    // and the workers' summed wait on the row above (WPP, microseconds)
    int32_t threads, fallback;
    int64_t wave_wait_us;
};

enum { MODE_INTER = 0, MODE_INTRA = 1 };
enum { PART_2Nx2N = 0, PART_2NxN, PART_Nx2N, PART_NxN,
       PART_2NxnU, PART_2NxnD, PART_nLx2N, PART_nRx2N };
enum { SCAN_DIAG = 0, SCAN_HORIZ, SCAN_VERT };
enum { PRED_L0 = 0, PRED_L1, PRED_BI };
enum { PF_INTRA = 0, PF_L0 = 1, PF_L1 = 2, PF_BI = 3 };

struct MvField {
    uint8_t pf;
    int32_t mv[2][2];
    int8_t  ref[2];
    int32_t poc[2];
};

static inline int imin(int a, int b) { return a < b ? a : b; }
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int iclip(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}
static inline int wrap16(int v) {
    v &= 0xFFFF;
    return v >= 0x8000 ? v - 0x10000 : v;
}

// Per-slice state shared by every substream parser: the read-only scan
// maps, the spatial-context grids (disjoint per-CTB writes; cross-row
// reads are ordered by the WPP wavefront progress counters), and the
// synchronization state for threaded WPP/tile parsing.
struct Shared {
    const SliceParams* P;
    Outputs* O;
    const uint8_t* rbsp;
    int64_t size;
    int w4, h4, ctbs_w, ctbs_h;
    std::vector<int32_t> zscan;
    std::vector<int8_t> ct_depth;
    std::vector<uint8_t> skip_grid;
    std::vector<int32_t> level_map[3];
    std::vector<int32_t> ts_order;
    std::vector<int32_t> tile_id;
    std::vector<int32_t> region_ctb;   // slice_no * n_tiles + tile_id
    int n_regions = 1;
    std::vector<int32_t> col_bd;
    bool tiles = false, wpp = false;
    int init_type = 0;
    // TMVP collocated motion grids (null when TMVP off)
    const uint8_t* col_pf = nullptr;
    const int32_t* col_mv = nullptr;
    const int32_t* col_rp = nullptr;
    // threaded-WPP wavefront: CTBs completed per CTB row (release) and
    // the CABAC context snapshot taken after each row's 2nd CTB
    std::unique_ptr<std::atomic<int>[]> row_progress;
    std::vector<std::array<uint8_t, CTX_STATE_BYTES>> row_snapshot;
    std::unique_ptr<std::atomic<int>[]> snapshot_ready;
    std::atomic<bool> any_err{false};

    void init(const SliceParams* p, Outputs* o, const uint8_t* data,
              int64_t sz) {
        P = p; O = o; rbsp = data; size = sz;
        int W = P->width, H = P->height;
        ctbs_w = (W + (1 << P->log2_ctb) - 1) >> P->log2_ctb;
        ctbs_h = (H + (1 << P->log2_ctb) - 1) >> P->log2_ctb;
        w4 = (ctbs_w << P->log2_ctb) >> 2;
        h4 = (ctbs_h << P->log2_ctb) >> 2;
        tiles = P->tiles_enabled != 0;
        wpp = P->entropy_coding_sync != 0;
        int ncols = tiles ? P->num_tile_cols : 1;
        int nrows = tiles ? P->num_tile_rows : 1;
        col_bd.resize(ncols + 1);
        std::vector<int32_t> row_bd(nrows + 1);
        if (P->n_col_bd_in == ncols + 1 && P->n_row_bd_in == nrows + 1) {
            for (int c = 0; c <= ncols; c++) col_bd[c] = P->col_bd_in[c];
            for (int r = 0; r <= nrows; r++) row_bd[r] = P->row_bd_in[r];
        } else {
            for (int c = 0; c <= ncols; c++) col_bd[c] = c * ctbs_w / ncols;
            for (int r = 0; r <= nrows; r++) row_bd[r] = r * ctbs_h / nrows;
        }
        tile_id.assign(ctbs_w * ctbs_h, 0);
        ts_order.clear();
        int tid = 0;
        for (int tr = 0; tr < nrows; tr++)
            for (int tc = 0; tc < ncols; tc++) {
                for (int y = row_bd[tr]; y < row_bd[tr + 1]; y++)
                    for (int x = col_bd[tc]; x < col_bd[tc + 1]; x++) {
                        ts_order.push_back(y * ctbs_w + x);
                        tile_id[y * ctbs_w + x] = tid;
                    }
                tid++;
            }
        region_ctb = tile_id;
        n_regions = tid;
        std::vector<int32_t> rs_to_ts(ctbs_w * ctbs_h);
        for (size_t t = 0; t < ts_order.size(); t++)
            rs_to_ts[ts_order[t]] = (int32_t)t;
        zscan.resize(h4 * w4);
        int n4 = 1 << (P->log2_ctb - 2);
        for (int y = 0; y < h4; y++)
            for (int x = 0; x < w4; x++) {
                int ctb = rs_to_ts[(y / n4) * ctbs_w + (x / n4)];
                int lx = x % n4, ly = y % n4, m = 0;
                for (int b = 0; b < P->log2_ctb - 2; b++) {
                    m |= ((lx >> b) & 1) << (2 * b);
                    m |= ((ly >> b) & 1) << (2 * b + 1);
                }
                zscan[y * w4 + x] = ctb * n4 * n4 + m;
            }
        ct_depth.assign(h4 * w4, 0);
        skip_grid.assign(h4 * w4, 0);
        for (int c = 0; c < 3; c++) level_map[c].assign(h4 * w4, 0);
        // context init type (9.3.2.2): I->0, P->1, B->2, swap on
        // cabac_init_flag
        init_type = P->slice_type == 2 ? 0 : (P->slice_type == 1 ? 1 : 2);
        if (P->cabac_init_present && P->cabac_init_flag &&
            P->slice_type != 2)
            init_type = 3 - init_type;
        // grid defaults (ALL grids initialized here so the Python caller
        // can hand over uninitialized buffers, and so a serial re-parse
        // after a failed threaded attempt starts from a clean slate)
        memset(O->ipm, 255, h4 * w4);
        memset(O->pred_mode, MODE_INTRA, h4 * w4);
        for (int i = 0; i < h4 * w4; i++)
            O->qp_y4[i] = (int8_t)P->slice_qp;
        memset(O->is_pcm, 0, h4 * w4);
        memset(O->tqb, 0, h4 * w4);
        memset(O->cbf_luma4, 0, h4 * w4);
        memset(O->bounds_v, 0, h4 * w4);
        memset(O->bounds_h, 0, h4 * w4);
        memset(O->mv_pf, 0, h4 * w4);
        memset(O->mv, 0, (size_t)h4 * w4 * 4 * sizeof(int32_t));
        memset(O->mv_poc, 0, (size_t)h4 * w4 * 2 * sizeof(int32_t));
        memset(O->mv_refidx, 0, (size_t)h4 * w4 * 2);
        memset(O->sao, 0, (size_t)ctbs_h * ctbs_w * 18 * sizeof(int16_t));
    }
};

struct Parser {
    SliceParams P;
    Outputs* O;
    const uint8_t* rbsp;
    int64_t size;
    Cabac cab;
    // ctx states + 4 persistent-rice stat counters (StatCoeff,
    // 9.3.3.13) kept contiguous so every CABAC-state snapshot
    // (WPP row entry, dependent-segment chain) carries both
    uint8_t ctx[CTX_STATE_BYTES];
    uint8_t* stat_coeff() { return ctx + NUM_CONTEXTS; }

    int w4, h4, ctbs_w, ctbs_h;
    // shared per-slice maps/grids (Shared below); pointer aliases so the
    // parse body reads identically in serial and threaded modes
    const int32_t* zscan;
    int8_t* ct_depth;
    uint8_t* skip_grid;
    int32_t* level_map[3];               // intra wavefront levels per plane
    const int32_t* ts_order;             // ts index -> ctb raster addr
    const int32_t* tile_id;              // per ctb
    int32_t* region_ctb = nullptr;       // slice x tile prediction regions
    int n_regions = 1;
    bool use_regions = false;            // region-gate availability
    int end_ts = 0;                      // CTBs parsed through (tile-scan)
    const int32_t* col_bd;               // tile column boundaries (CTBs)
    int n_col_bd = 0;
    bool tiles = false, wpp = false;
    struct Shared* S = nullptr;

    // per-CU state
    int cu_tqb = 0, cu_qp = 0, cu_pred_mode = MODE_INTRA;
    int cu_part_mode = PART_2Nx2N, cu_depth = 0;
    int pu_modes[4] = {1, 1, 1, 1};
    int intra_mode_c = 1;
    int pu_cmode[4] = {1, 1, 1, 1};   // per-PU chroma modes (4:4:4 NxN)
    int cu_log2_cb = 3;
    bool err = false;
    int64_t wait_ns = 0;      // spent in wait_row (threaded WPP)
    // cu_qp_delta state (lc->qp_y / qPy_pred / first_qp_group)
    int qp_y = 0, qPy_pred = 0;
    bool first_qp_group = true;
    int is_qp_coded = 0, qg_delta = 0, qg_mask = 0;
    int cu_x0 = 0, cu_y0 = 0;
    // cu_chroma_qp_offset state (lc->tu.cu_qp_offset_cb/cr; syntax.py:317)
    int is_cqo_coded = 0, cu_qp_off_cb = 0, cu_qp_off_cr = 0;
    // coded intra_chroma_pred_mode was "derived" (idx 4, DM) per PU —
    // the cross-component-prediction gate (hevc.c:1465-1474)
    int pu_cderived[4] = {1, 1, 1, 1};
    int cderived0 = 1;
    // TMVP state (bind)
    const uint8_t* col_pf = nullptr;
    const int32_t* col_mv = nullptr;
    const int32_t* col_rp = nullptr;
    bool tmvp = false, has_future = false;

    // ---------------- binding / per-substream init ----------------
    void bind(Shared& sh, Outputs* out) {
        S = &sh;
        P = *sh.P;
        O = out;
        rbsp = sh.rbsp;
        size = sh.size;
        w4 = sh.w4; h4 = sh.h4;
        ctbs_w = sh.ctbs_w; ctbs_h = sh.ctbs_h;
        zscan = sh.zscan.data();
        ct_depth = sh.ct_depth.data();
        skip_grid = sh.skip_grid.data();
        for (int c = 0; c < 3; c++) level_map[c] = sh.level_map[c].data();
        ts_order = sh.ts_order.data();
        tile_id = sh.tile_id.data();
        region_ctb = sh.region_ctb.data();
        n_regions = sh.n_regions;
        use_regions = sh.tiles || P.slice_no > 0;
        col_bd = sh.col_bd.data();
        n_col_bd = (int)sh.col_bd.size();
        tiles = sh.tiles;
        wpp = sh.wpp;
        cab.data = rbsp;
        cab.nbits = size * 8;
        cab.pad_bytes = size + RBSP_PAD;
        cu_qp = P.slice_qp;
        qp_y = qPy_pred = P.slice_qp;
        first_qp_group = true;
        is_qp_coded = 0;
        qg_delta = 0;
        is_cqo_coded = 0;
        cu_qp_off_cb = cu_qp_off_cr = 0;
        qg_mask = P.cu_qp_delta_enabled
            ? (1 << (P.log2_ctb - P.diff_cu_qp_delta_depth)) - 1 : 0;
        col_pf = sh.col_pf;
        col_mv = sh.col_mv;
        col_rp = sh.col_rp;
        tmvp = P.temporal_mvp && col_pf != nullptr;
        has_future = false;
        for (int lx = 0; lx < 2; lx++)
            for (int i = 0; i < (lx ? P.num_ref1 : P.num_ref0); i++)
                if (P.ref_poc[lx][i] > P.cur_poc) has_future = true;
    }

    inline int bin(int base, int inc = 0) { return cab.decode_bin(ctx, base + inc); }

    inline int tile_of4(int x4, int y4) const {
        // prediction-region id (slice x tile) — slices break prediction
        // exactly like tiles do (Python mirror: tile4 = region4)
        if (!use_regions) return 0;
        int cx = (x4 << 2) >> P.log2_ctb, cy = (y4 << 2) >> P.log2_ctb;
        return region_ctb[cy * ctbs_w + cx];
    }
    inline bool same_tile4(int xa4, int ya4, int xb4, int yb4) const {
        return tile_of4(xa4, ya4) == tile_of4(xb4, yb4);
    }
    inline int tile_width_of(int rs) const {
        int rx = rs % ctbs_w;
        for (int c = 0; c + 1 < n_col_bd; c++)
            if (rx >= col_bd[c] && rx < col_bd[c + 1])
                return col_bd[c + 1] - col_bd[c];
        return ctbs_w;
    }

    // ---------------- grids ----------------
    inline void fill_u8(uint8_t* g, int x4, int y4, int n4w, int n4h,
                        uint8_t v) {
        for (int j = 0; j < n4h; j++)
            memset(g + (y4 + j) * w4 + x4, v, n4w);
    }

    // ---------------- top level ----------------
    int decode() {
        int cs = 1 << P.log2_ctb;
        int n_ctb = ctbs_w * ctbs_h;
        int start_ts = P.start_ts;
        // CTBs into the current tile at the segment start
        int ctb_tile_rs = 0;
        if (start_ts > 0) {
            int t0 = tile_id[ts_order[start_ts]];
            int k = start_ts;
            while (k > 0 && tile_id[ts_order[k - 1]] == t0) k--;
            ctb_tile_rs = start_ts - k;
        }
        end_ts = start_ts;
        uint8_t saved_ctx[CTX_STATE_BYTES];
        bool have_saved = false;
        int it = P.slice_type == 2 ? 0 : (P.slice_type == 1 ? 1 : 2);
        if (P.cabac_init_present && P.cabac_init_flag && P.slice_type != 2)
            it = 3 - it;
        for (int ts = start_ts; ts < n_ctb && !err; ts++) {
            int rs = ts_order[ts];
            int x0 = (rs % ctbs_w) * cs;
            int y0 = (rs / ctbs_w) * cs;
            int tw = tile_width_of(rs);
            if (P.slice_no)   // paint region before availability queries
                region_ctb[rs] = P.slice_no * n_regions + tile_id[rs];
            if (ts > start_ts) {
                int prev_rs = ts_order[ts - 1];
                bool new_tile = tiles && tile_id[rs] != tile_id[prev_rs];
                if (new_tile) {
                    ctb_tile_rs = 0;
                    cab.reinit(cab.consumed_bytes() * 8);
                    init_ctx_states(it);
                    first_qp_group = true;
                }
                if (wpp && ctb_tile_rs % tw == 0 && !new_tile) {
                    first_qp_group = true;
                    if (cab.terminate() != 1) { err = true; break; }
                    cab.reinit(cab.consumed_bytes() * 8);
                    if (tw == 1 || !have_saved) init_ctx_states(it);
                    // load_states copies contexts ONLY: StatCoeff
                    // carries over serially (hevc_cabac.c:562)
                    else memcpy(ctx, saved_ctx, NUM_CONTEXTS);
                }
            }
            if (P.sao_enabled && (P.slice_sao_luma || P.slice_sao_chroma))
                sao_params(x0, y0);
            { ProfScope _pq(4); coding_quadtree(x0, y0, P.log2_ctb, 0); }
            ctb_tile_rs++;
            if (wpp && (ctb_tile_rs % tw == 2 ||
                        (tw == 2 && ctb_tile_rs % tw == 0))) {
                memcpy(saved_ctx, ctx, CTX_STATE_BYTES);
                have_saved = true;
            }
            int end = cab.terminate();
            if (end) { end_ts = ts + 1; break; }
            if (ts == n_ctb - 1) err = true;   // missing end_of_slice
        }
        return err ? -1 : 0;
    }

    // ---------------- threaded substream entries ----------------
    // One WPP CTB row; ss_bit = the row's entry-point bit position.
    // Wavefront protocol (2-CTB lag, pthread_slice.c analogue): before
    // CTB x, row r waits for row r-1 to have finished min(x+2, W) CTBs;
    // after its 2nd CTB each row publishes the CABAC context snapshot the
    // next row starts from (9.3.1 sync).
    int decode_wpp_row(int row, int64_t ss_bit) {
        int cs = 1 << P.log2_ctb;
        cab.reinit(ss_bit);
        if (row == 0 || ctbs_w == 1) {
            init_ctx_states(S->init_type);
        } else {
            if (!wait_row([&] {
                    return S->snapshot_ready[row - 1]
                        .load(std::memory_order_acquire) != 0; }))
                return fail_row(row);
            memcpy(ctx, S->row_snapshot[row - 1].data(), NUM_CONTEXTS);
        }
        cu_qp = P.slice_qp;
        for (int x = 0; x < ctbs_w && !err; x++) {
            if (row > 0) {
                int need = imin(x + 2, ctbs_w);
                if (!wait_row([&] {
                        return S->row_progress[row - 1]
                            .load(std::memory_order_acquire) >= need; }))
                    return fail_row(row);
            }
            int x0 = x * cs, y0 = row * cs;
            if (P.sao_enabled && (P.slice_sao_luma || P.slice_sao_chroma))
                sao_params(x0, y0);
            { ProfScope _pq(4); coding_quadtree(x0, y0, P.log2_ctb, 0); }
            if (x == 1) {
                memcpy(S->row_snapshot[row].data(), ctx, CTX_STATE_BYTES);
                S->snapshot_ready[row].store(1, std::memory_order_release);
            }
            int end = cab.terminate();
            if (row == ctbs_h - 1 && x == ctbs_w - 1) {
                if (end != 1) err = true;
            } else if (end) {
                err = true;
            }
            if (!err)
                S->row_progress[row].store(x + 1,
                                           std::memory_order_release);
        }
        if (!err && row != ctbs_h - 1 && cab.terminate() != 1)
            err = true;                       // end_of_subset_one_bit
        if (err) return fail_row(row);
        return 0;
    }

    // Spin until ready() holds; false once another row has failed. The
    // clock is read only after the first check fails, so a row that
    // never waits reads none.
    template <class Ready> bool wait_row(Ready ready) {
        if (ready()) return true;
        auto t0 = std::chrono::steady_clock::now();
        bool ok = true;
        while (!ready()) {
            if (S->any_err.load(std::memory_order_relaxed)) {
                ok = false;
                break;
            }
            std::this_thread::yield();
        }
        wait_ns += std::chrono::duration_cast<std::chrono::nanoseconds>(
            std::chrono::steady_clock::now() - t0).count();
        return ok;
    }

    int fail_row(int row) {
        err = true;
        S->any_err.store(true, std::memory_order_relaxed);
        // unblock waiters permanently (they re-check any_err)
        S->row_progress[row].store(ctbs_w, std::memory_order_release);
        S->snapshot_ready[row].store(1, std::memory_order_release);
        return -1;
    }

    // One tile (fully independent: CABAC reset, prediction and context
    // reads tile-gated).
    int decode_tile(int ts_begin, int ts_end, int64_t ss_bit) {
        int cs = 1 << P.log2_ctb;
        int n_ctb = ctbs_w * ctbs_h;
        cab.reinit(ss_bit);
        init_ctx_states(S->init_type);
        cu_qp = P.slice_qp;
        for (int ts = ts_begin; ts < ts_end && !err; ts++) {
            int rs = ts_order[ts];
            int x0 = (rs % ctbs_w) * cs;
            int y0 = (rs / ctbs_w) * cs;
            if (P.sao_enabled && (P.slice_sao_luma || P.slice_sao_chroma))
                sao_params(x0, y0);
            { ProfScope _pq(4); coding_quadtree(x0, y0, P.log2_ctb, 0); }
            int end = cab.terminate();
            if (ts == n_ctb - 1) { if (end != 1) err = true; }
            else if (end) err = true;
        }
        if (err) {
            S->any_err.store(true, std::memory_order_relaxed);
            return -1;
        }
        return 0;
    }

    void init_ctx_states(int it) {
        int qp = iclip(P.slice_qp, 0, 51);
        for (int i = 0; i < NUM_CONTEXTS; i++) {
            int iv = INIT_VALUES[it * NUM_CONTEXTS + i];
            int slope = (iv >> 4) * 5 - 45;
            int off = ((iv & 15) << 3) - 16;
            int pre = iclip(((slope * qp) >> 4) + off, 1, 126);
            ctx[i] = pre <= 63 ? (uint8_t)((63 - pre) << 1)
                               : (uint8_t)(((pre - 64) << 1) | 1);
        }
        memset(stat_coeff(), 0, 4);   // persistent-rice StatCoeff reset
    }

    // ---------------- SAO ----------------
    void sao_params(int x0, int y0) {
        ProfScope _prof(3);
        int rx = x0 >> P.log2_ctb, ry = y0 >> P.log2_ctb;
        int16_t* dst = O->sao + (ry * ctbs_w + rx) * 18;
        if (x0 > 0 &&
            (!use_regions || region_ctb[ry * ctbs_w + rx] ==
                             region_ctb[ry * ctbs_w + rx - 1]) &&
            bin(CTX_SAO_MERGE_FLAG)) {
            memcpy(dst, O->sao + (ry * ctbs_w + rx - 1) * 18,
                   18 * sizeof(int16_t));
            return;
        }
        if (y0 > 0 &&
            (!use_regions || region_ctb[ry * ctbs_w + rx] ==
                             region_ctb[(ry - 1) * ctbs_w + rx]) &&
            bin(CTX_SAO_MERGE_FLAG)) {
            memcpy(dst, O->sao + ((ry - 1) * ctbs_w + rx) * 18,
                   18 * sizeof(int16_t));
            return;
        }
        int length = (1 << (imin(P.bit_depth, 10) - 5)) - 1;
        for (int c = 0; c < 3; c++) {
            if ((c == 0 && !P.slice_sao_luma) ||
                (c == 1 && !P.slice_sao_chroma) ||
                (c == 2 && !P.slice_sao_chroma))
                continue;
            int type;
            if (c == 2) type = dst[1 * 6 + 0];
            else if (!bin(CTX_SAO_TYPE_IDX)) type = 0;
            else type = cab.bypass() ? 2 : 1;
            dst[c * 6 + 0] = (int16_t)type;
            if (!type) continue;
            int offs[4];
            for (int i = 0; i < 4; i++) {
                int v = 0;
                while (v < length && cab.bypass()) v++;
                offs[i] = v;
            }
            if (type == 1) {
                for (int i = 0; i < 4; i++)
                    if (offs[i] && cab.bypass()) offs[i] = -offs[i];
                dst[c * 6 + 1] = (int16_t)cab.bypass_bits(5);
            } else {
                offs[2] = -offs[2];
                offs[3] = -offs[3];
                dst[c * 6 + 1] = (c == 2) ? dst[1 * 6 + 1]
                                          : (int16_t)cab.bypass_bits(2);
            }
            for (int i = 0; i < 4; i++) dst[c * 6 + 2 + i] = (int16_t)offs[i];
        }
    }

    // ---------------- quadtree ----------------
    void coding_quadtree(int x0, int y0, int log2_cb, int depth) {
        if (err) return;
        int cb = 1 << log2_cb;
        bool boundary = x0 + cb > P.width || y0 + cb > P.height;
        int split;
        if (!boundary && log2_cb > P.log2_min_cb) {
            int inc = 0;
            int x4 = x0 >> 2, y4 = y0 >> 2;
            if (x0 > 0 && same_tile4(x4, y4, x4 - 1, y4) &&
                ct_depth[y4 * w4 + x4 - 1] > depth) inc++;
            if (y0 > 0 && same_tile4(x4, y4, x4, y4 - 1) &&
                ct_depth[(y4 - 1) * w4 + x4] > depth) inc++;
            split = bin(CTX_SPLIT_CU_FLAG, inc);
        } else {
            split = log2_cb > P.log2_min_cb ? 1 : 0;
        }
        if (P.cu_qp_delta_enabled &&
            log2_cb >= P.log2_ctb - P.diff_cu_qp_delta_depth) {
            // new quantization group (hevc.c:2527)
            is_qp_coded = 0;
            qg_delta = 0;
        }
        if (P.cu_chroma_qp_offset_enabled &&
            log2_cb >= P.log2_ctb - P.diff_cu_chroma_qp_offset_depth)
            is_cqo_coded = 0;            // hevc.c:2531-2534
        if (split) {
            int h = cb >> 1;
            static const int dxy[4][2] = {{0,0},{1,0},{0,1},{1,1}};
            for (int i = 0; i < 4; i++) {
                int x1 = x0 + dxy[i][0] * h, y1 = y0 + dxy[i][1] * h;
                if (x1 < P.width && y1 < P.height)
                    coding_quadtree(x1, y1, log2_cb - 1, depth + 1);
            }
            if (P.cu_qp_delta_enabled &&
                ((x0 + cb) & qg_mask) == 0 && ((y0 + cb) & qg_mask) == 0)
                qPy_pred = qp_y;                  // hevc.c:2565
        } else {
            coding_unit(x0, y0, log2_cb, depth);
        }
    }

    void set_qPy(int x_base, int y_base) {
        // ff_hevc_set_qPy + get_qPy_pred (hevc_filter.c:91-143)
        int ctb_mask = (1 << P.log2_ctb) - 1;
        int x_qg = x_base - (x_base & qg_mask);
        int y_qg = y_base - (y_base & qg_mask);
        bool avail_a = (x_base & ctb_mask) && (x_qg & ctb_mask);
        bool avail_b = (y_base & ctb_mask) && (y_qg & ctb_mask);
        int pred;
        if (first_qp_group || (x_qg == 0 && y_qg == 0)) {
            first_qp_group = !is_qp_coded;
            pred = P.slice_qp;
        } else {
            pred = qPy_pred;
        }
        int qa = avail_a ? O->qp_y4[(y_qg >> 2) * w4 + ((x_qg - 1) >> 2)]
                         : pred;
        int qb = avail_b ? O->qp_y4[((y_qg - 1) >> 2) * w4 + (x_qg >> 2)]
                         : pred;
        int qp = (qa + qb + 1) >> 1;
        if (qg_delta != 0) {
            int off = P.qp_bd_offset;
            qp = (qp + qg_delta + 52 + 2 * off) % (52 + off) - off;
        }
        qp_y = qp;
        cu_qp = qp;
    }

    // ---------------- CU ----------------
    void coding_unit(int x0, int y0, int log2_cb, int depth) {
        coding_unit_body(x0, y0, log2_cb, depth);
        if (P.cu_qp_delta_enabled) {
            // CU tail (hevc.c:2489-2500): derive the (possibly
            // prediction-only) QP, paint it, update decode-order pred
            if (!is_qp_coded) set_qPy(x0, y0);
            int cb = 1 << log2_cb;
            int x4 = x0 >> 2, y4 = y0 >> 2, n4 = cb >> 2;
            for (int j = 0; j < n4; j++)
                memset(O->qp_y4 + (y4 + j) * w4 + x4,
                       (uint8_t)(int8_t)qp_y, n4);
            if (((x0 + cb) & qg_mask) == 0 && ((y0 + cb) & qg_mask) == 0)
                qPy_pred = qp_y;
        }
    }

    void coding_unit_body(int x0, int y0, int log2_cb, int depth) {
        int cb = 1 << log2_cb;
        int x4 = x0 >> 2, y4 = y0 >> 2, n4 = cb >> 2;
        for (int j = 0; j < n4; j++)
            memset(&ct_depth[(y4 + j) * w4 + x4], depth, n4);
        cu_tqb = 0;
        cu_qp = P.cu_qp_delta_enabled ? qp_y : P.slice_qp;
        cu_x0 = x0; cu_y0 = y0; cu_log2_cb = log2_cb;
        cu_depth = depth;
        for (int j = 0; j < n4; j++)
            memset(O->qp_y4 + (y4 + j) * w4 + x4, (int8_t)cu_qp, n4);
        if (P.transquant_bypass_enabled) {
            cu_tqb = bin(CTX_CU_TRANSQUANT_BYPASS_FLAG);
            if (cu_tqb) fill_u8(O->tqb, x4, y4, n4, n4, 1);
        }
        if (P.slice_type != 2) {
            int inc = 0;
            if (x0 > 0 && same_tile4(x4, y4, x4 - 1, y4) &&
                skip_grid[y4 * w4 + x4 - 1]) inc++;
            if (y0 > 0 && same_tile4(x4, y4, x4, y4 - 1) &&
                skip_grid[(y4 - 1) * w4 + x4]) inc++;
            int skip = bin(CTX_CU_SKIP_FLAG, inc);
            if (skip) {
                for (int j = 0; j < n4; j++)
                    memset(&skip_grid[(y4 + j) * w4 + x4], 1, n4);
                cu_pred_mode = MODE_INTER;
                fill_u8(O->pred_mode, x4, y4, n4, n4, MODE_INTER);
                prediction_unit(x0, y0, cb, cb, PART_2Nx2N, 0, log2_cb,
                                x0, y0, true);
                for (int j = 0; j < n4; j++) O->bounds_v[(y4 + j) * w4 + x4] = 1;
                memset(O->bounds_h + y4 * w4 + x4, 1, n4);
                return;
            }
            if (!bin(CTX_PRED_MODE_FLAG)) { inter_cu(x0, y0, log2_cb, depth); return; }
        }
        cu_pred_mode = MODE_INTRA;
        fill_u8(O->pred_mode, x4, y4, n4, n4, MODE_INTRA);
        set_motion_intra(x4, y4, n4);
        int part_mode = PART_2Nx2N;
        if (log2_cb == P.log2_min_cb) {
            if (!bin(CTX_PART_MODE)) part_mode = PART_NxN;
        }
        cu_part_mode = part_mode;
        int pcm = 0;
        if (P.pcm_enabled && part_mode == PART_2Nx2N &&
            log2_cb >= P.log2_min_pcm && log2_cb <= P.log2_max_pcm)
            pcm = cab.terminate();
        if (pcm) {
            pcm_sample(x0, y0, log2_cb);
            fill_u8(O->is_pcm, x4, y4, n4, n4, 1);
            fill_u8(O->ipm, x4, y4, n4, n4, 1);
            for (int j = 0; j < n4; j++) O->bounds_v[(y4 + j) * w4 + x4] = 1;
            memset(O->bounds_h + y4 * w4 + x4, 1, n4);
            return;
        }
        intra_prediction_unit(x0, y0, log2_cb, part_mode);
        int intra_split = part_mode == PART_NxN ? 1 : 0;
        int max_depth = P.max_trafo_depth_intra + intra_split;
        static const int one2[2] = {1, 1};
        transform_tree(x0, y0, x0, y0, log2_cb, 0, 0, max_depth,
                       intra_split, one2, one2);
    }

    void set_motion_intra(int x4, int y4, int n4) {
        for (int j = 0; j < n4; j++) {
            memset(O->mv_pf + (y4 + j) * w4 + x4, PF_INTRA, n4);
            for (int i = 0; i < n4; i++) {
                int idx = (y4 + j) * w4 + x4 + i;
                O->mv[idx * 4] = O->mv[idx * 4 + 1] = 0;
                O->mv[idx * 4 + 2] = O->mv[idx * 4 + 3] = 0;
                O->mv_poc[idx * 2] = O->mv_poc[idx * 2 + 1] = 0;
                O->mv_refidx[idx * 2] = O->mv_refidx[idx * 2 + 1] = 0;
            }
        }
    }

    // ---------------- PCM ----------------
    void pcm_sample(int x0, int y0, int log2_cb) {
        int cb = 1 << log2_cb;
        int64_t end_byte = cab.consumed_bytes();
        int64_t bitp = end_byte * 8;
        int hs = P.chroma_format_idc == 0 ? 0 :
                 (P.chroma_format_idc == 3 ? 0 : 1);
        int vs = P.chroma_format_idc == 1 ? 1 : 0;
        int csz_h = cb >> hs, csz_v = cb >> vs;
        int total = cb * cb + 2 * csz_h * csz_v;
        if (O->n_pcm >= O->pcm_cap ||
            O->pcm_used + total > O->pcm_arena_cap) { err = true; return; }
        int32_t* meta = O->pcm_meta + O->n_pcm * 3;
        meta[0] = x0; meta[1] = y0; meta[2] = cb;
        uint16_t* dst = O->pcm_samples + O->pcm_used;
        auto rd = [&](int nb) {
            uint32_t v = 0;
            for (int i = 0; i < nb; i++) {
                int64_t p = bitp++;
                int b = p < size * 8 ? (rbsp[p >> 3] >> (7 - (p & 7))) & 1 : 0;
                v = (v << 1) | b;
            }
            return v;
        };
        int shift_l = P.bit_depth - P.pcm_bd;
        int shift_c = P.bit_depth - P.pcm_bd_c;
        for (int i = 0; i < cb * cb; i++) dst[i] = (uint16_t)(rd(P.pcm_bd) << shift_l);
        for (int i = 0; i < 2 * csz_h * csz_v; i++)
            dst[cb * cb + i] = (uint16_t)(rd(P.pcm_bd_c) << shift_c);
        O->pcm_used += total;
        O->n_pcm++;
        cab.reinit(bitp);
    }

    // ---------------- intra modes ----------------
    void intra_prediction_unit(int x0, int y0, int log2_cb, int part_mode) {
        int n_pu = part_mode == PART_NxN ? 4 : 1;
        int pb = (1 << log2_cb) >> (part_mode == PART_NxN ? 1 : 0);
        int prev[4];
        for (int i = 0; i < n_pu; i++) prev[i] = bin(CTX_PREV_INTRA_LUMA_PRED_FLAG);
        int modes[4];
        for (int i = 0; i < n_pu; i++) {
            int px = x0 + (i & 1) * pb, py = y0 + (i >> 1) * pb;
            int cands[3];
            mpm_candidates(px, py, cands);
            int mode;
            if (prev[i]) {
                int idx = 0;
                while (idx < 2 && cab.bypass()) idx++;
                mode = cands[idx];
            } else {
                int rem = cab.bypass_bits(5);
                // sort cands ascending
                int sc[3] = {cands[0], cands[1], cands[2]};
                for (int a = 0; a < 2; a++)
                    for (int b2 = a + 1; b2 < 3; b2++)
                        if (sc[b2] < sc[a]) { int t = sc[a]; sc[a] = sc[b2]; sc[b2] = t; }
                mode = rem;
                for (int c = 0; c < 3; c++) if (mode >= sc[c]) mode++;
            }
            modes[i] = mode;
            int nn = pb >> 2;
            fill_u8(O->ipm, px >> 2, py >> 2, nn, nn, (uint8_t)mode);
        }
        for (int i = 0; i < 4; i++) pu_modes[i] = modes[i % n_pu];
        if (n_pu == 4) for (int i = 0; i < 4; i++) pu_modes[i] = modes[i];
        // chroma mode: per PU for 4:4:4, single otherwise (7.3.8.5;
        // syntax.py:876); 4:2:2 maps through Table 8-3 (hevc.c:2310)
        int n_cpu = P.chroma_format_idc == 3 ? n_pu : 1;
        int cmodes[4], cder[4];
        for (int i = 0; i < n_cpu; i++) {
            if (!bin(CTX_INTRA_CHROMA_PRED_MODE)) {
                cmodes[i] = modes[i];
                cder[i] = 1;               // coded idx 4 (derived, DM)
            } else {
                static const int table[4] = {0, 26, 10, 1};
                int m = table[cab.bypass_bits(2)];
                cmodes[i] = (m == modes[i]) ? 34 : m;
                cder[i] = 0;
            }
        }
        if (P.chroma_format_idc == 2) {
            static const int tab422[35] = {
                0, 1, 2, 2, 2, 2, 3, 5, 7, 8, 10, 12, 13, 15, 17, 18,
                19, 20, 21, 22, 23, 23, 24, 24, 25, 25, 26, 27, 27, 28,
                28, 29, 29, 30, 31};
            for (int i = 0; i < n_cpu; i++)
                cmodes[i] = tab422[cmodes[i]];
        }
        intra_mode_c = cmodes[0];
        cderived0 = cder[0];
        for (int i = 0; i < 4; i++) {
            pu_cmode[i] = cmodes[i % n_cpu];
            pu_cderived[i] = cder[i % n_cpu];
        }
        if (n_cpu == 4)
            for (int i = 0; i < 4; i++) {
                pu_cmode[i] = cmodes[i];
                pu_cderived[i] = cder[i];
            }
    }

    int chroma_derived_at(int x0, int y0) {
        // coded intra_chroma_pred_mode idx == 4 for the PU containing
        // this TB (lc->tu.chroma_mode_c, hevc.c:1465-1474)
        if (P.chroma_format_idc == 3 && cu_part_mode == PART_NxN) {
            int half = 1 << (cu_log2_cb - 1);
            int bi = ((y0 - cu_y0) >= half ? 2 : 0) +
                     ((x0 - cu_x0) >= half ? 1 : 0);
            return pu_cderived[bi];
        }
        return cderived0;
    }

    int chroma_mode_at(int x0, int y0) {
        // tu.intra_pred_mode_c selection (hevc.c:1460; syntax.py:1063)
        if (P.chroma_format_idc == 3 && cu_part_mode == PART_NxN) {
            int half = 1 << (cu_log2_cb - 1);
            int bi = ((y0 - cu_y0) >= half ? 2 : 0) +
                     ((x0 - cu_x0) >= half ? 1 : 0);
            return pu_cmode[bi];
        }
        return intra_mode_c;
    }

    void mpm_candidates(int x0, int y0, int* out) {
        int x4 = x0 >> 2, y4 = y0 >> 2;
        int zc = zscan[y4 * w4 + x4];
        int cand_a = 1, cand_b = 1;
        if (x0 > 0 && same_tile4(x4, y4, x4 - 1, y4) &&
            zscan[y4 * w4 + x4 - 1] < zc &&
            O->pred_mode[y4 * w4 + x4 - 1] == MODE_INTRA &&
            !O->is_pcm[y4 * w4 + x4 - 1])
            cand_a = O->ipm[y4 * w4 + x4 - 1];
        if (y0 > 0 && (y0 & ((1 << P.log2_ctb) - 1)) != 0 &&
            same_tile4(x4, y4, x4, y4 - 1) &&
            zscan[(y4 - 1) * w4 + x4] < zc &&
            O->pred_mode[(y4 - 1) * w4 + x4] == MODE_INTRA &&
            !O->is_pcm[(y4 - 1) * w4 + x4])
            cand_b = O->ipm[(y4 - 1) * w4 + x4];
        if (cand_a == cand_b) {
            if (cand_a < 2) { out[0] = 0; out[1] = 1; out[2] = 26; }
            else {
                out[0] = cand_a;
                out[1] = 2 + ((cand_a + 29) % 32);
                out[2] = 2 + ((cand_a - 1) % 32);
            }
        } else {
            out[0] = cand_a; out[1] = cand_b;
            if (cand_a != 0 && cand_b != 0) out[2] = 0;
            else if (cand_a + cand_b < 2) out[2] = 26;
            else out[2] = 1;
        }
    }

    // ---------------- inter CU ----------------
    void inter_cu(int x0, int y0, int log2_cb, int depth) {
        int cb = 1 << log2_cb;
        int x4 = x0 >> 2, y4 = y0 >> 2, n4 = cb >> 2;
        cu_pred_mode = MODE_INTER;
        fill_u8(O->pred_mode, x4, y4, n4, n4, MODE_INTER);
        int part_mode = part_mode_inter(log2_cb);
        cu_part_mode = part_mode;
        int pus[4][4], n_pu;
        pu_geometry(x0, y0, cb, part_mode, pus, &n_pu);
        bool first_merge = false;
        for (int i = 0; i < n_pu; i++) {
            bool m = prediction_unit(pus[i][0], pus[i][1], pus[i][2],
                                     pus[i][3], part_mode, i, log2_cb,
                                     x0, y0, false);
            if (i == 0) first_merge = m;
        }
        int rqt_root_cbf = 1;
        if (!(part_mode == PART_2Nx2N && first_merge))
            rqt_root_cbf = bin(CTX_RQT_ROOT_CBF);
        if (rqt_root_cbf) {
            int inter_split = P.max_trafo_depth_inter == 0 &&
                              part_mode != PART_2Nx2N;
            int max_depth = P.max_trafo_depth_inter + (inter_split ? 1 : 0);
            static const int one2[2] = {1, 1};
            transform_tree(x0, y0, x0, y0, log2_cb, 0, 0, max_depth,
                           inter_split, one2, one2);
        } else {
            for (int j = 0; j < n4; j++) O->bounds_v[(y4 + j) * w4 + x4] = 1;
            memset(O->bounds_h + y4 * w4 + x4, 1, n4);
        }
    }

    int part_mode_inter(int log2_cb) {
        if (bin(CTX_PART_MODE, 0)) return PART_2Nx2N;
        if (log2_cb == P.log2_min_cb) {
            if (bin(CTX_PART_MODE, 1)) return PART_2NxN;
            if (log2_cb == 3) return PART_Nx2N;
            if (bin(CTX_PART_MODE, 2)) return PART_Nx2N;
            return PART_NxN;
        }
        if (!P.amp_enabled)
            return bin(CTX_PART_MODE, 1) ? PART_2NxN : PART_Nx2N;
        if (bin(CTX_PART_MODE, 1)) {
            if (bin(CTX_PART_MODE, 3)) return PART_2NxN;
            return cab.bypass() ? PART_2NxnD : PART_2NxnU;
        }
        if (bin(CTX_PART_MODE, 3)) return PART_Nx2N;
        return cab.bypass() ? PART_nRx2N : PART_nLx2N;
    }

    static void pu_geometry(int x0, int y0, int cb, int pm,
                            int out[4][4], int* n) {
        int h = cb >> 1, q = cb >> 2;
        switch (pm) {
        case PART_2Nx2N: out[0][0]=x0;out[0][1]=y0;out[0][2]=cb;out[0][3]=cb; *n=1; break;
        case PART_2NxN:  out[0][0]=x0;out[0][1]=y0;out[0][2]=cb;out[0][3]=h;
                         out[1][0]=x0;out[1][1]=y0+h;out[1][2]=cb;out[1][3]=h; *n=2; break;
        case PART_Nx2N:  out[0][0]=x0;out[0][1]=y0;out[0][2]=h;out[0][3]=cb;
                         out[1][0]=x0+h;out[1][1]=y0;out[1][2]=h;out[1][3]=cb; *n=2; break;
        case PART_NxN:   out[0][0]=x0;out[0][1]=y0;out[0][2]=h;out[0][3]=h;
                         out[1][0]=x0+h;out[1][1]=y0;out[1][2]=h;out[1][3]=h;
                         out[2][0]=x0;out[2][1]=y0+h;out[2][2]=h;out[2][3]=h;
                         out[3][0]=x0+h;out[3][1]=y0+h;out[3][2]=h;out[3][3]=h; *n=4; break;
        case PART_2NxnU: out[0][0]=x0;out[0][1]=y0;out[0][2]=cb;out[0][3]=q;
                         out[1][0]=x0;out[1][1]=y0+q;out[1][2]=cb;out[1][3]=cb-q; *n=2; break;
        case PART_2NxnD: out[0][0]=x0;out[0][1]=y0;out[0][2]=cb;out[0][3]=cb-q;
                         out[1][0]=x0;out[1][1]=y0+cb-q;out[1][2]=cb;out[1][3]=q; *n=2; break;
        case PART_nLx2N: out[0][0]=x0;out[0][1]=y0;out[0][2]=q;out[0][3]=cb;
                         out[1][0]=x0+q;out[1][1]=y0;out[1][2]=cb-q;out[1][3]=cb; *n=2; break;
        default:         out[0][0]=x0;out[0][1]=y0;out[0][2]=cb-q;out[0][3]=cb;
                         out[1][0]=x0+cb-q;out[1][1]=y0;out[1][2]=q;out[1][3]=cb; *n=2; break;
        }
    }

    // ---------------- motion helpers (mirror bitstream/mvs.py) -------------
    inline MvField tab(int x, int y) {
        int idx = (y >> 2) * w4 + (x >> 2);
        MvField f;
        f.pf = O->mv_pf[idx];
        f.mv[0][0] = O->mv[idx * 4];     f.mv[0][1] = O->mv[idx * 4 + 1];
        f.mv[1][0] = O->mv[idx * 4 + 2]; f.mv[1][1] = O->mv[idx * 4 + 3];
        f.ref[0] = O->mv_refidx[idx * 2]; f.ref[1] = O->mv_refidx[idx * 2 + 1];
        f.poc[0] = O->mv_poc[idx * 2];   f.poc[1] = O->mv_poc[idx * 2 + 1];
        return f;
    }
    void set_pu_grid(int x0, int y0, int w, int h, const MvField& f) {
        int x4 = x0 >> 2, y4 = y0 >> 2;
        int nw = imax(1, w >> 2), nh = imax(1, h >> 2);
        for (int j = 0; j < nh; j++)
            for (int i = 0; i < nw; i++) {
                int idx = (y4 + j) * w4 + x4 + i;
                O->mv_pf[idx] = f.pf;
                O->mv[idx * 4] = f.mv[0][0];     O->mv[idx * 4 + 1] = f.mv[0][1];
                O->mv[idx * 4 + 2] = f.mv[1][0]; O->mv[idx * 4 + 3] = f.mv[1][1];
                O->mv_refidx[idx * 2] = f.ref[0]; O->mv_refidx[idx * 2 + 1] = f.ref[1];
                O->mv_poc[idx * 2] = f.poc[0];   O->mv_poc[idx * 2 + 1] = f.poc[1];
            }
    }

    void neighbour_flags(int x0, int y0, int w, int h, bool* cand_left,
                         bool* cand_up, bool* cand_up_left,
                         bool* cand_up_right, bool* cand_bottom_left) {
        int ctb = 1 << P.log2_ctb;
        int x0b = x0 & (ctb - 1), y0b = y0 & (ctb - 1);
        bool up = y0b ? true : (y0 > 0);
        bool left = x0b ? true : (x0 > 0);
        if (y0 == 0) up = false;
        if (x0 == 0) left = false;
        *cand_up = up;
        *cand_left = left;
        *cand_up_left = (!x0b && !y0b) ? (x0 > 0 && y0 > 0) : (left && up);
        *cand_up_right = ((x0b + w) == ctb) ? ((y0 > 0) && !y0b) : up;
        *cand_bottom_left = (y0 + h) >= P.height ? false : left;
        if (use_regions) {
            // merge/AMVP neighbours must lie in the same prediction
            // region: tile (6.4.1) AND slice
            int x4c = x0 >> 2, y4c = y0 >> 2;
            if (*cand_left && !same_tile4(x4c, y4c, (x0 - 1) >> 2, y4c))
                *cand_left = false;
            if (*cand_up && !same_tile4(x4c, y4c, x4c, (y0 - 1) >> 2))
                *cand_up = false;
            if (*cand_up_left &&
                !same_tile4(x4c, y4c, (x0 - 1) >> 2, (y0 - 1) >> 2))
                *cand_up_left = false;
            if (*cand_up_right && (x0 + w) >> 2 < w4 &&
                !same_tile4(x4c, y4c, (x0 + w) >> 2, (y0 - 1) >> 2))
                *cand_up_right = false;
            if (*cand_bottom_left &&
                !same_tile4(x4c, y4c, (x0 - 1) >> 2, (y0 + h) >> 2))
                *cand_bottom_left = false;
        }
    }

    inline bool zscan_avail(int xc, int yc, int xn, int yn) {
        if ((yn >> P.log2_ctb) < (yc >> P.log2_ctb) ||
            (xn >> P.log2_ctb) < (xc >> P.log2_ctb))
            return true;
        return zscan[(yn >> 2) * w4 + (xn >> 2)] <=
               zscan[(yc >> 2) * w4 + (xc >> 2)];
    }
    inline bool avail_pu(bool cand, int x, int y) {
        if (!cand) return false;
        return O->mv_pf[(y >> 2) * w4 + (x >> 2)] != PF_INTRA;
    }
    inline bool diff_mer(int xn, int yn, int xp, int yp) {
        int p = P.log2_parallel_merge;
        return (xn >> p) == (xp >> p) && (yn >> p) == (yp >> p);
    }
    static bool same_cand(const MvField& a, const MvField& b) {
        if (a.pf != b.pf) return false;
        if (a.pf == PF_BI)
            return a.poc[0] == b.poc[0] && a.poc[1] == b.poc[1] &&
                   a.mv[0][0] == b.mv[0][0] && a.mv[0][1] == b.mv[0][1] &&
                   a.mv[1][0] == b.mv[1][0] && a.mv[1][1] == b.mv[1][1];
        int lx = a.pf == PF_L0 ? 0 : 1;
        return a.poc[lx] == b.poc[lx] && a.mv[lx][0] == b.mv[lx][0] &&
               a.mv[lx][1] == b.mv[lx][1];
    }

    MvField merge_mode(int x0, int y0, int w, int h, int log2_cb,
                       int part_mode, int part_idx, int merge_idx,
                       int cu_x, int cu_y) {
        int w2 = w, h2 = h;
        bool single_mcl = false;
        if (P.log2_parallel_merge > 2 && (1 << log2_cb) == 8) {
            single_mcl = true;
            x0 = cu_x; y0 = cu_y; w = h = 1 << log2_cb; part_idx = 0;
        }
        MvField cand = spatial_merge(x0, y0, w, h, part_mode, part_idx,
                                     single_mcl, merge_idx);
        if (cand.pf == PF_BI && (w2 + h2) == 12) cand.pf = PF_L0;
        return cand;
    }

    MvField spatial_merge(int x0, int y0, int w, int h, int part_mode,
                          int part_idx, bool single_mcl, int merge_idx) {
        bool cl, cu_, cul, cur, cbl;
        neighbour_flags(x0, y0, w, h, &cl, &cu_, &cul, &cur, &cbl);
        int xa1 = x0 - 1, ya1 = y0 + h - 1;
        int xb1 = x0 + w - 1, yb1 = y0 - 1;
        int xb0 = x0 + w, yb0 = y0 - 1;
        int xa0 = x0 - 1, ya0 = y0 + h;
        int xb2 = x0 - 1, yb2 = y0 - 1;
        int nb_refs = P.slice_type == 1 ? P.num_ref0
                                        : imin(P.num_ref0, P.num_ref1);
        MvField lst[5];
        int n = 0;
        bool av_a1 = false, av_b1 = false;
        // A1
        if (!((!single_mcl && part_idx == 1 &&
               (part_mode == PART_Nx2N || part_mode == PART_nLx2N ||
                part_mode == PART_nRx2N)) ||
              diff_mer(xa1, ya1, x0, y0))) {
            av_a1 = avail_pu(cl, xa1, ya1);
            if (av_a1) {
                lst[n++] = tab(xa1, ya1);
                if (merge_idx == 0) return lst[0];
            }
        }
        // B1
        if (!((!single_mcl && part_idx == 1 &&
               (part_mode == PART_2NxN || part_mode == PART_2NxnU ||
                part_mode == PART_2NxnD)) ||
              diff_mer(xb1, yb1, x0, y0))) {
            av_b1 = avail_pu(cu_, xb1, yb1);
            if (av_b1 && !(av_a1 && same_cand(tab(xb1, yb1), tab(xa1, ya1)))) {
                lst[n++] = tab(xb1, yb1);
                if (merge_idx == n - 1) return lst[n - 1];
            }
        }
        // B0
        bool av_b0 = xb0 < P.width && avail_pu(cur, xb0, yb0) &&
                     zscan_avail(x0, y0, xb0, yb0) &&
                     !diff_mer(xb0, yb0, x0, y0);
        if (av_b0 && !(av_b1 && same_cand(tab(xb0, yb0), tab(xb1, yb1)))) {
            lst[n++] = tab(xb0, yb0);
            if (merge_idx == n - 1) return lst[n - 1];
        }
        // A0
        bool av_a0 = ya0 < P.height && avail_pu(cbl, xa0, ya0) &&
                     zscan_avail(x0, y0, xa0, ya0) &&
                     !diff_mer(xa0, ya0, x0, y0);
        if (av_a0 && !(av_a1 && same_cand(tab(xa0, ya0), tab(xa1, ya1)))) {
            lst[n++] = tab(xa0, ya0);
            if (merge_idx == n - 1) return lst[n - 1];
        }
        // B2
        bool av_b2 = avail_pu(cul, xb2, yb2) && !diff_mer(xb2, yb2, x0, y0);
        if (av_b2 && n != 4 &&
            !(av_a1 && same_cand(tab(xb2, yb2), tab(xa1, ya1))) &&
            !(av_b1 && same_cand(tab(xb2, yb2), tab(xb1, yb1)))) {
            lst[n++] = tab(xb2, yb2);
            if (merge_idx == n - 1) return lst[n - 1];
        }
        // temporal merge candidate (hevc_mvs.c:418-447)
        if (tmvp && n < P.max_merge_cand) {
            int mv_l0[2] = {0, 0}, mv_l1[2] = {0, 0};
            bool av_l0 = temporal_mv(x0, y0, w, h, 0, 0, mv_l0);
            bool av_l1 = P.slice_type == 0 &&
                         temporal_mv(x0, y0, w, h, 0, 1, mv_l1);
            if (av_l0 || av_l1) {
                MvField f;
                memset(&f, 0, sizeof(f));
                f.pf = (uint8_t)((av_l0 ? 1 : 0) | (av_l1 ? 2 : 0));
                f.mv[0][0] = mv_l0[0]; f.mv[0][1] = mv_l0[1];
                f.mv[1][0] = mv_l1[0]; f.mv[1][1] = mv_l1[1];
                f.poc[0] = av_l0 ? P.ref_poc[0][0] : 0;
                f.poc[1] = av_l1 ? P.ref_poc[1][0] : 0;
                lst[n++] = f;
                if (merge_idx == n - 1) return lst[n - 1];
            }
        }
        int n_orig = n;
        if (P.slice_type == 0 && n_orig > 1 && n_orig < P.max_merge_cand) {
            static const int comb[12][2] = {{0,1},{1,0},{0,2},{2,0},{1,2},{2,1},
                                            {0,3},{3,0},{1,3},{3,1},{2,3},{3,2}};
            int lim = n_orig * (n_orig - 1);
            for (int ci = 0; ci < lim && n < P.max_merge_cand; ci++) {
                const MvField& c0 = lst[comb[ci][0]];
                const MvField& c1 = lst[comb[ci][1]];
                if ((c0.pf & PF_L0) && (c1.pf & PF_L1) &&
                    (c0.poc[0] != c1.poc[1] ||
                     c0.mv[0][0] != c1.mv[1][0] ||
                     c0.mv[0][1] != c1.mv[1][1])) {
                    MvField f;
                    f.pf = PF_BI;
                    f.mv[0][0] = c0.mv[0][0]; f.mv[0][1] = c0.mv[0][1];
                    f.mv[1][0] = c1.mv[1][0]; f.mv[1][1] = c1.mv[1][1];
                    f.ref[0] = c0.ref[0]; f.ref[1] = c1.ref[1];
                    f.poc[0] = c0.poc[0]; f.poc[1] = c1.poc[1];
                    lst[n++] = f;
                    if (merge_idx == n - 1) return lst[n - 1];
                }
            }
        }
        int zero_idx = 0;
        while (n < P.max_merge_cand) {
            MvField f;
            memset(&f, 0, sizeof(f));
            f.pf = PF_L0 + (P.slice_type == 0 ? 2 : 0);
            int ri = zero_idx < nb_refs ? zero_idx : 0;
            f.ref[0] = f.ref[1] = (int8_t)ri;
            f.poc[0] = P.num_ref0 ? P.ref_poc[0][ri] : 0;
            f.poc[1] = (P.slice_type == 0 && P.num_ref1) ? P.ref_poc[1][ri] : 0;
            lst[n++] = f;
            if (merge_idx == n - 1) return lst[n - 1];
            zero_idx++;
        }
        return lst[imin(merge_idx, n - 1)];
    }

    static void mv_scale(int* mv, int td, int tb) {
        td = iclip(td, -128, 127);
        tb = iclip(tb, -128, 127);
        int tx = (0x4000 + abs(td / 2)) / td;
        int sf = iclip((tb * tx + 32) >> 6, -4096, 4095);
        int x = sf * mv[0];
        int y = sf * mv[1];
        mv[0] = iclip((x + 127 + (x < 0)) >> 8, -32768, 32767);
        mv[1] = iclip((y + 127 + (y < 0)) >> 8, -32768, 32767);
    }

    bool is_lt_poc(int lx, int poc) {
        int n = lx ? P.num_ref1 : P.num_ref0;
        for (int i = 0; i < n; i++)
            if (P.ref_poc[lx][i] == poc) return P.ref_lt[lx][i] != 0;
        return false;
    }

    // ---- TMVP (mirror of mvs.py temporal_mv/_derive_col_mv; truth
    // temporal_luma_motion_vector hevc_mvs.c:227,
    // derive_temporal_colocated_mvs :172) ------------------------------
    bool is_col_lt(int poc) {
        for (int i = 0; i < P.n_col_lt; i++)
            if (P.col_lt_poc[i] == poc) return P.col_lt_flag[i] != 0;
        return false;
    }

    bool derive_col_mv(int pf, const int32_t* mv2, const int32_t* rp2,
                       int ref_idx, int X, int* out) {
        int l;
        if (!(pf & 1)) l = 1;
        else if (pf == 1) l = 0;
        else l = has_future ? (P.colloc_from_l0 == 0 ? 0 : 1) : X;
        int cur_ref_poc = P.ref_poc[X][ref_idx];
        bool cur_lt = P.ref_lt[X][ref_idx] != 0;
        int col_ref_poc = rp2[l];
        if (is_col_lt(col_ref_poc) != cur_lt)
            return false;          // 8.5.3.2.8: LT/ST mismatch -> unavail
        out[0] = mv2[l * 2];
        out[1] = mv2[l * 2 + 1];
        if (cur_lt) return true;   // long-term: never scaled
        int col_poc_diff = P.col_poc - col_ref_poc;
        int cur_poc_diff = P.cur_poc - cur_ref_poc;
        if (col_poc_diff == cur_poc_diff || col_poc_diff == 0) return true;
        mv_scale(out, col_poc_diff, cur_poc_diff);
        return true;
    }

    bool temporal_mv(int x0, int y0, int w, int h, int ref_idx, int X,
                     int* out) {
        if (!tmvp) return false;
        int ctb = P.log2_ctb;
        int cx[2], cy[2];
        int nc = 0;
        int xbr = x0 + w, ybr = y0 + h;
        // bottom-right candidate (same CTB row, in-picture), else center
        if ((y0 >> ctb) == (ybr >> ctb) && ybr < P.height &&
            xbr < P.width) {
            cx[nc] = xbr; cy[nc] = ybr; nc++;
        }
        cx[nc] = x0 + (w >> 1); cy[nc] = y0 + (h >> 1); nc++;
        for (int i = 0; i < nc; i++) {
            int x = (cx[i] >> 4) << 4;
            int y = (cy[i] >> 4) << 4;
            int idx = (y >> 2) * w4 + (x >> 2);
            int pf = col_pf[idx];
            if (pf == 0) continue;
            if (derive_col_mv(pf, col_mv + (size_t)idx * 4,
                              col_rp + (size_t)idx * 2, ref_idx, X, out))
                return true;
        }
        return false;
    }

    // AMVP; out[2] = predictor mv
    void amvp(int x0, int y0, int w, int h, int lx, int ref_idx,
              int mvp_flag, int* out) {
        bool cl, cu_, cul, cur, cbl;
        neighbour_flags(x0, y0, w, h, &cl, &cu_, &cul, &cur, &cbl);
        int cur_poc_ref = P.ref_poc[lx][ref_idx];
        bool cur_lt = P.ref_lt[lx][ref_idx] != 0;
        int pf_l0 = lx, pf_l1 = 1 - lx;

        auto mp_mx = [&](int x, int y, int pli, int* mv) -> bool {
            MvField f = tab(x, y);
            if ((f.pf & (1 << pli)) && f.poc[pli] == cur_poc_ref) {
                mv[0] = f.mv[pli][0]; mv[1] = f.mv[pli][1];
                return true;
            }
            return false;
        };
        auto mp_mx_lt = [&](int x, int y, int pli, int* mv) -> bool {
            MvField f = tab(x, y);
            if (f.pf & (1 << pli)) {
                bool col_lt = is_lt_poc(pli, f.poc[pli]);
                if (col_lt == cur_lt) {
                    mv[0] = f.mv[pli][0]; mv[1] = f.mv[pli][1];
                    if (!cur_lt) {
                        int elist_poc = f.poc[pli];
                        if (elist_poc != cur_poc_ref) {
                            int td = P.cur_poc - elist_poc;
                            if (!td) td = 1;
                            mv_scale(mv, td, P.cur_poc - cur_poc_ref);
                        }
                    }
                    return true;
                }
            }
            return false;
        };
        int xa0 = x0 - 1, ya0 = y0 + h;
        int xa1 = x0 - 1, ya1 = y0 + h - 1;
        bool av_a0 = ya0 < P.height && avail_pu(cbl, xa0, ya0) &&
                     zscan_avail(x0, y0, xa0, ya0);
        bool av_a1 = avail_pu(cl, xa1, ya1);
        bool is_scaled = av_a0 || av_a1;
        int mxa[2] = {0, 0}, mxb[2] = {0, 0};
        bool av_lxa = false;
        if (av_a0 && (mp_mx(xa0, ya0, pf_l0, mxa) ||
                      mp_mx(xa0, ya0, pf_l1, mxa))) av_lxa = true;
        if (!av_lxa && av_a1 && (mp_mx(xa1, ya1, pf_l0, mxa) ||
                                 mp_mx(xa1, ya1, pf_l1, mxa))) av_lxa = true;
        if (!av_lxa && av_a0 && (mp_mx_lt(xa0, ya0, pf_l0, mxa) ||
                                 mp_mx_lt(xa0, ya0, pf_l1, mxa))) av_lxa = true;
        if (!av_lxa && av_a1 && (mp_mx_lt(xa1, ya1, pf_l0, mxa) ||
                                 mp_mx_lt(xa1, ya1, pf_l1, mxa))) av_lxa = true;
        if (av_lxa && !mvp_flag) { out[0] = mxa[0]; out[1] = mxa[1]; return; }
        int xb0 = x0 + w, yb0 = y0 - 1;
        int xb1 = x0 + w - 1, yb1 = y0 - 1;
        int xb2 = x0 - 1, yb2 = y0 - 1;
        bool av_b0 = xb0 < P.width && avail_pu(cur, xb0, yb0) &&
                     zscan_avail(x0, y0, xb0, yb0);
        bool av_b1 = avail_pu(cu_, xb1, yb1);
        bool av_b2 = avail_pu(cul, xb2, yb2);
        bool av_lxb = false;
        if (av_b0 && (mp_mx(xb0, yb0, pf_l0, mxb) ||
                      mp_mx(xb0, yb0, pf_l1, mxb))) av_lxb = true;
        if (!av_lxb && av_b1 && (mp_mx(xb1, yb1, pf_l0, mxb) ||
                                 mp_mx(xb1, yb1, pf_l1, mxb))) av_lxb = true;
        if (!av_lxb && av_b2 && (mp_mx(xb2, yb2, pf_l0, mxb) ||
                                 mp_mx(xb2, yb2, pf_l1, mxb))) av_lxb = true;
        if (!is_scaled) {
            if (av_lxb) { av_lxa = true; mxa[0] = mxb[0]; mxa[1] = mxb[1]; }
            av_lxb = false;
            if (av_b0 && (mp_mx_lt(xb0, yb0, pf_l0, mxb) ||
                          mp_mx_lt(xb0, yb0, pf_l1, mxb))) av_lxb = true;
            if (!av_lxb && av_b1 && (mp_mx_lt(xb1, yb1, pf_l0, mxb) ||
                                     mp_mx_lt(xb1, yb1, pf_l1, mxb)))
                av_lxb = true;
            if (!av_lxb && av_b2 && (mp_mx_lt(xb2, yb2, pf_l0, mxb) ||
                                     mp_mx_lt(xb2, yb2, pf_l1, mxb)))
                av_lxb = true;
        }
        int cands[2][2];
        int nc = 0;
        if (av_lxa) { cands[nc][0] = mxa[0]; cands[nc][1] = mxa[1]; nc++; }
        if (av_lxb && (!av_lxa || mxa[0] != mxb[0] || mxa[1] != mxb[1])) {
            cands[nc][0] = mxb[0]; cands[nc][1] = mxb[1]; nc++;
        }
        // temporal AMVP candidate (hevc_mvs.c:807-815)
        if (nc < 2 && tmvp) {
            int mv_col[2];
            if (temporal_mv(x0, y0, w, h, ref_idx, lx, mv_col)) {
                cands[nc][0] = mv_col[0];
                cands[nc][1] = mv_col[1];
                nc++;
            }
        }
        while (nc < 2) { cands[nc][0] = cands[nc][1] = 0; nc++; }
        out[0] = cands[mvp_flag][0];
        out[1] = cands[mvp_flag][1];
    }

    // ---------------- PU ----------------
    bool prediction_unit(int x0, int y0, int w, int h, int part_mode,
                         int part_idx, int log2_cb, int cu_x, int cu_y,
                         bool is_skip) {
        ProfScope _prof(1);
        MvField f;
        memset(&f, 0, sizeof(f));
        bool merge = true;
        if (is_skip || bin(CTX_MERGE_FLAG)) {
            int merge_idx = 0;
            if (P.max_merge_cand > 1) {
                merge_idx = bin(CTX_MERGE_IDX);
                if (merge_idx) {
                    while (merge_idx < P.max_merge_cand - 1 && cab.bypass())
                        merge_idx++;
                }
            }
            f = merge_mode(x0, y0, w, h, log2_cb, part_mode, part_idx,
                           merge_idx, cu_x, cu_y);
        } else {
            merge = false;
            int idc = PRED_L0;
            if (P.slice_type == 0) {
                if (w + h == 12)
                    idc = bin(CTX_INTER_PRED_IDC, 4) ? PRED_L1 : PRED_L0;
                else if (bin(CTX_INTER_PRED_IDC, cu_depth))
                    idc = PRED_BI;
                else
                    idc = bin(CTX_INTER_PRED_IDC, 4) ? PRED_L1 : PRED_L0;
            }
            int pf = 0;
            for (int lx = 0; lx < 2; lx++) {
                if ((lx == 0 && idc == PRED_L1) ||
                    (lx == 1 && idc == PRED_L0))
                    continue;
                int nref = lx ? P.num_ref1 : P.num_ref0;
                int ref = ref_idx_decode(nref);
                int mvd[2] = {0, 0};
                if (lx == 1 && P.mvd_l1_zero && idc == PRED_BI) {
                    // inferred zero mvd
                } else {
                    mvd_coding(mvd);
                }
                int mvp_flag = bin(CTX_MVP_L0_FLAG);
                int pred[2];
                amvp(x0, y0, w, h, lx, ref, mvp_flag, pred);
                f.mv[lx][0] = wrap16(pred[0] + mvd[0]);
                f.mv[lx][1] = wrap16(pred[1] + mvd[1]);
                f.ref[lx] = (int8_t)ref;
                f.poc[lx] = P.ref_poc[lx][ref];
                pf |= 1 << lx;
            }
            f.pf = (uint8_t)pf;
        }
        set_pu_grid(x0, y0, w, h, f);
        if (O->n_pb >= O->pb_cap) { err = true; return merge; }
        int32_t* pb = O->pb + O->n_pb * 14;
        pb[0] = x0; pb[1] = y0; pb[2] = w; pb[3] = h;
        pb[4] = (f.pf & 1) ? 1 : 0;
        pb[5] = f.mv[0][0]; pb[6] = f.mv[0][1]; pb[7] = f.poc[0];
        pb[8] = (f.pf & 2) ? 1 : 0;
        pb[9] = f.mv[1][0]; pb[10] = f.mv[1][1]; pb[11] = f.poc[1];
        pb[12] = f.ref[0]; pb[13] = f.ref[1];   // weighted-pred lookup
        O->n_pb++;
        return merge;
    }

    int ref_idx_decode(int num_ref) {
        int i = 0, mx = num_ref - 1, max_ctx = imin(mx, 2);
        while (i < max_ctx && bin(CTX_REF_IDX_L0, i)) i++;
        if (i == 2) { while (i < mx && cab.bypass()) i++; }
        return i;
    }

    void mvd_coding(int* mvd) {
        int gx = bin(CTX_ABS_MVD_GREATER0_FLAG, 0);
        int gy = bin(CTX_ABS_MVD_GREATER0_FLAG, 0);
        if (gx) gx += bin(CTX_ABS_MVD_GREATER1_FLAG, 1);
        if (gy) gy += bin(CTX_ABS_MVD_GREATER1_FLAG, 1);
        for (int k = 0; k < 2; k++) {
            int g = k == 0 ? gx : gy;
            if (g == 2) {
                int v = 2, kk = 1;
                while (kk < 32 && cab.bypass()) { v += 1 << kk; kk++; }
                while (kk) { kk--; v += cab.bypass() << kk; }
                mvd[k] = cab.bypass() ? -v : v;
            } else if (g == 1) {
                mvd[k] = cab.bypass() ? -1 : 1;
            }
        }
    }

    // ---------------- transform tree ----------------
    void transform_tree(int x0, int y0, int xb, int yb, int log2_tr,
                        int depth, int blk_idx, int max_depth,
                        int intra_split, const int* cbf_cb,
                        const int* cbf_cr) {
        // cbf_cb/cbf_cr are 2-vectors: [1] is the second (lower) chroma
        // TB of a 4:2:2 pair (hls_transform_tree, hevc.c:1452/1495;
        // python mirror syntax.py:933)
        if (err) return;
        const int is422 = P.chroma_format_idc == 2;
        int split = 0;
        if (log2_tr <= P.log2_max_tb && log2_tr > P.log2_min_tb &&
            depth < max_depth && !(intra_split && depth == 0)) {
            split = bin(CTX_SPLIT_TRANSFORM_FLAG, 5 - log2_tr);
        } else if (log2_tr > P.log2_max_tb || (intra_split && depth == 0)) {
            split = 1;
        }
        int my_cb[2] = {cbf_cb[0], cbf_cb[1]};
        int my_cr[2] = {cbf_cr[0], cbf_cr[1]};
        if (log2_tr > 2 || P.chroma_format_idc == 3) {
            if (depth == 0 || cbf_cb[0]) {
                my_cb[0] = bin(CTX_CBF_CBCR, depth);
                if (is422 && (!split || log2_tr == 3))
                    my_cb[1] = bin(CTX_CBF_CBCR, depth);
            } else { my_cb[0] = my_cb[1] = 0; }
            if (depth == 0 || cbf_cr[0]) {
                my_cr[0] = bin(CTX_CBF_CBCR, depth);
                if (is422 && (!split || log2_tr == 3))
                    my_cr[1] = bin(CTX_CBF_CBCR, depth);
            } else { my_cr[0] = my_cr[1] = 0; }
        }
        if (split) {
            int h = 1 << (log2_tr - 1);
            static const int dxy[4][2] = {{0,0},{1,0},{0,1},{1,1}};
            for (int i = 0; i < 4; i++)
                transform_tree(x0 + dxy[i][0] * h, y0 + dxy[i][1] * h, x0, y0,
                               log2_tr - 1, depth + 1, i, max_depth,
                               intra_split, my_cb, my_cr);
            return;
        }
        int cbf_luma = 1;
        if (cu_pred_mode == MODE_INTRA || depth != 0 ||
            my_cb[0] || my_cr[0] ||
            (is422 && (my_cb[1] || my_cr[1])))
            cbf_luma = bin(CTX_CBF_LUMA, depth ? 0 : 1);
        transform_unit(x0, y0, xb, yb, log2_tr, depth, blk_idx,
                       cbf_luma, my_cb, my_cr);
    }

    int luma_mode_at(int x0, int y0) {
        return O->ipm[(y0 >> 2) * w4 + (x0 >> 2)];
    }

    void transform_unit(int x0, int y0, int xb, int yb, int log2_tr,
                        int depth, int blk_idx, int cbf_luma,
                        const int* cbf_cb, const int* cbf_cr) {
        const int is422 = P.chroma_format_idc == 2;
        int any_cbf = cbf_luma || cbf_cb[0] || cbf_cr[0] ||
            (is422 && (cbf_cb[1] || cbf_cr[1]));
        if (any_cbf &&
            P.cu_qp_delta_enabled && !is_qp_coded) {
            // cu_qp_delta_abs: TU prefix (<=5, ctx 0 then 1) + EG0
            // suffix (ff_hevc_cu_qp_delta_abs, hevc_cabac.c:731)
            int prefix = 0, inc = 0;
            while (prefix < 5 && bin(CTX_CU_QP_DELTA, inc)) {
                prefix++;
                inc = 1;
            }
            int d = prefix;
            if (prefix == 5) {
                int k = 0, suffix = 0;
                while (cab.bypass()) { suffix += 1 << k; k++; }
                while (k) { k--; suffix += cab.bypass() << k; }
                d = prefix + suffix;
            }
            if (d && cab.bypass()) d = -d;   // cu_qp_delta_sign_flag
            qg_delta = d;
            is_qp_coded = 1;
            set_qPy(cu_x0, cu_y0);
        }
        int cbf_chroma = cbf_cb[0] || cbf_cr[0] ||
            (is422 && (cbf_cb[1] || cbf_cr[1]));
        if (P.cu_chroma_qp_offset_enabled && cbf_chroma && !cu_tqb &&
            !is_cqo_coded) {
            // cu_chroma_qp_offset_flag/_idx (hevc.c:1247-1263)
            int flag = bin(CTX_CU_CHROMA_QP_OFFSET_FLAG);
            int idx = 0;
            if (flag && P.n_cqo_list > 1) {
                // TR-coded idx, all bins on context 0; cMax is
                // max(5, len-1) — the reference's exact behavior
                // (ff_hevc_cu_chroma_qp_offset_idx, hevc_cabac.c:768)
                int n = imax(5, P.n_cqo_list - 1);
                while (idx < n && bin(CTX_CU_CHROMA_QP_OFFSET_IDX)) idx++;
            }
            cu_qp_off_cb = flag ? P.cqo_cb[idx] : 0;
            cu_qp_off_cr = flag ? P.cqo_cr[idx] : 0;
            is_cqo_coded = 1;
        }
        int n4 = 1 << imax(0, log2_tr - 2);
        int x4 = x0 >> 2, y4 = y0 >> 2;
        for (int j = 0; j < n4; j++) O->bounds_v[(y4 + j) * w4 + x4] = 1;
        memset(O->bounds_h + y4 * w4 + x4, 1, n4);
        if (cbf_luma)
            for (int j = 0; j < n4; j++)
                memset(O->cbf_luma4 + (y4 + j) * w4 + x4, 1, n4);
        if (cu_pred_mode == MODE_INTRA) {
            int mode = luma_mode_at(x0, y0);
            emit_intra_job(0, x0, y0, 1 << log2_tr, mode);
        }
        if (cbf_luma) {
            int mode = cu_pred_mode == MODE_INTRA ? luma_mode_at(x0, y0) : -1;
            residual(x0, y0, log2_tr, 0, mode);
        }
        // chroma TB log2 = luma - hshift (hevc.c:1210); 4:2:2 codes a
        // vertical pair of square TBs per component (hevc.c:1302;
        // python mirror syntax.py:1005-1041)
        const int hs = P.chroma_format_idc == 3 ? 0 : 1;
        const int vs = P.chroma_format_idc == 1 ? 1 : 0;
        const int n_c = is422 ? 2 : 1;
        int mode_c = chroma_mode_at(x0, y0);
        if (log2_tr > 2 || P.chroma_format_idc == 3) {
            int clog2 = log2_tr - hs;
            int csz = 1 << clog2;
            int cx = x0 >> hs, cy0 = y0 >> vs;
            // cross-component prediction (RExt, hevc.c:1295): active for
            // 4:4:4 when luma has residual and the CU is inter or the
            // chroma mode is derived-from-luma (python syntax.py:1049)
            int cross_pf = P.cross_component && cbf_luma &&
                (cu_pred_mode == MODE_INTER || chroma_derived_at(x0, y0));
            for (int pl = 1; pl <= 2; pl++) {
                const int* cbf = pl == 1 ? cbf_cb : cbf_cr;
                int scale = cross_pf ? res_scale(pl - 1) : 0;
                for (int i = 0; i < n_c; i++) {
                    int cy = cy0 + (i << clog2);
                    if (cu_pred_mode == MODE_INTRA)
                        emit_intra_job(pl, cx, cy, csz, mode_c);
                    if (cbf[i])
                        residual(cx, cy, clog2, pl, mode_c, scale);
                    else if (scale)
                        emit_zero_ccp(cx, cy, clog2, pl, scale);
                }
            }
        } else if (blk_idx == 3) {
            int cx = xb >> hs, cy0 = yb >> vs;
            for (int pl = 1; pl <= 2; pl++) {
                const int* cbf = pl == 1 ? cbf_cb : cbf_cr;
                for (int i = 0; i < n_c; i++) {
                    int cy = cy0 + (i << 2);
                    if (cu_pred_mode == MODE_INTRA)
                        emit_intra_job(pl, cx, cy, 4, mode_c);
                    if (cbf[i]) residual(cx, cy, 2, pl, mode_c);
                }
            }
        }
    }

    // ---------------- intra job emission ----------------
    void emit_intra_job(int plane, int x, int y, int size, int mode) {
        ProfScope _prof(2);
        if (O->n_ij >= O->ij_cap) { err = true; return; }
        int32_t* m = O->ij_meta + O->n_ij * 8;
        int filt = ((plane == 0 || P.chroma_format_idc == 3) &&
                    !P.intra_smoothing_disabled) ? 1 : 0;
        m[0] = plane; m[1] = x; m[2] = y; m[3] = size; m[4] = mode; m[5] = filt;
        uint8_t* av = O->ij_avail + O->n_ij * 132;
        memset(av, 0, 132);
        int hs = plane ? (P.chroma_format_idc == 3 ? 0 : 1) : 0;
        int vs = plane ? (P.chroma_format_idc == 1 ? 1 : 0) : 0;
        int lx0 = x << hs, ly0 = y << vs;
        int zc = zscan[(ly0 >> 2) * w4 + (lx0 >> 2)];
        int tid0 = tile_of4(lx0 >> 2, ly0 >> 2);
        auto ok = [&](int lx, int ly) -> int {
            if (lx < 0 || ly < 0 || lx >= P.width || ly >= P.height) return 0;
            if (zscan[(ly >> 2) * w4 + (lx >> 2)] >= zc) return 0;
            if (use_regions && tile_of4(lx >> 2, ly >> 2) != tid0)
                return 0;
            if (P.constrained_intra_pred &&
                O->pred_mode[(ly >> 2) * w4 + (lx >> 2)] != MODE_INTRA)
                return 0;
            return 1;
        };
        // availability is uniform per 4-sample run: transitions along an
        // edge happen at min-(chroma-)TB boundaries, which are 4-sample
        // aligned in every chroma format — evaluate once per group and
        // replicate (4x fewer neighbour probes)
        for (int i = 0; i < 2 * size; i += 4) {
            uint8_t v = (uint8_t)ok((x - 1) << hs,
                                    (y + 2 * size - 1 - i) << vs);
            av[i] = av[i + 1] = av[i + 2] = av[i + 3] = v;
        }
        av[2 * size] = (uint8_t)ok((x - 1) << hs, (y - 1) << vs);
        for (int j = 0; j < 2 * size; j += 4) {
            uint8_t v = (uint8_t)ok((x + j) << hs, (y - 1) << vs);
            uint8_t* t = av + 2 * size + 1 + j;
            t[0] = t[1] = t[2] = t[3] = v;
        }
        // dependency level (wavefront batching; mirrors models/pipeline.py)
        // — one probe per plane CELL (4 plane samples, TB origins are
        // 4-aligned so each av group is exactly one level_map cell)
        int32_t* lm = level_map[plane];
        int deps = 0;
        auto dep = [&](int sx, int sy) {
            int v = lm[(sy >> 2) * w4 + (sx >> 2)];
            if (v > deps) deps = v;
        };
        for (int i = 0; i < 2 * size; i += 4)
            if (av[i]) dep(x - 1, y + 2 * size - 1 - i);
        if (av[2 * size]) dep(x - 1, y - 1);
        for (int j = 0; j < 2 * size; j += 4)
            if (av[2 * size + 1 + j]) dep(x + j, y - 1);
        int lvl = deps + 1;
        int n4j = imax(1, size >> 2);
        for (int j = 0; j < n4j; j++)
            for (int i = 0; i < n4j; i++)
                lm[((y >> 2) + j) * w4 + (x >> 2) + i] = lvl;
        m[6] = lvl; m[7] = 0;
        O->n_ij++;
    }

    // ---------------- residual coding ----------------
    int res_scale(int idx) {
        // log2_res_scale_abs_plus1 + sign -> res_scale_val
        // (hls_cross_component_pred, hevc.c:1150; 4 TU ctx per comp)
        int i = 0;
        while (i < 4 && bin(CTX_LOG2_RES_SCALE_ABS, 4 * idx + i)) i++;
        if (i == 0) return 0;
        int sign = bin(CTX_RES_SCALE_SIGN_FLAG, idx);
        return (1 << (i - 1)) * (1 - 2 * sign);
    }

    void emit_zero_ccp(int x0, int y0, int log2_tr, int c_idx, int scale) {
        // zero-cbf chroma still receives the scaled luma residual
        // (hevc.c:1315-1329): a zero-level bypass block carrying only
        // cross_scale (python mirror syntax.py:1068-1074)
        int size = 1 << log2_tr;
        if (O->n_cb >= O->cb_cap ||
            O->lvl_used + size * size > O->lvl_cap) { err = true; return; }
        memset(O->cb_levels + O->lvl_used, 0,
               (size_t)size * size * sizeof(int16_t));
        int32_t* meta = O->cb_meta + O->n_cb * 8;
        meta[0] = c_idx; meta[1] = x0; meta[2] = y0; meta[3] = log2_tr;
        meta[4] = 0;
        meta[5] = 4 | ((scale + 9) << 6);    // tqb | biased cross_scale
        meta[6] = O->lvl_used;
        meta[7] = 0;
        O->lvl_used += size * size;
        O->n_cb++;
    }

    void residual(int x0, int y0, int log2_tr, int c_idx,
                  int pred_mode_intra, int cross_scale = 0) {
        ProfScope _prof(0);
        if (err) return;
        int size = 1 << log2_tr;
        if (O->n_cb >= O->cb_cap ||
            O->lvl_used + size * size > O->lvl_cap) { err = true; return; }
        int16_t* levels = O->cb_levels + O->lvl_used;
        memset(levels, 0, size * size * sizeof(int16_t));
        int blk_maxa = 0;    // max |level|, recorded for the int8 fast pack
        int transform_skip = 0;
        if (!cu_tqb && P.transform_skip_enabled && log2_tr <= P.log2_max_ts)
            transform_skip = bin(CTX_TRANSFORM_SKIP_FLAG, c_idx ? 1 : 0);
        // explicit RDPCM (RExt): inter TS/lossless TBs (syntax.py:1111)
        int explicit_rd = -1;
        if (cu_pred_mode == MODE_INTER && P.explicit_rdpcm &&
            (transform_skip || cu_tqb)) {
            if (bin(CTX_EXPLICIT_RDPCM_FLAG, c_idx ? 1 : 0))
                explicit_rd = bin(CTX_EXPLICIT_RDPCM_DIR_FLAG,
                                  c_idx ? 1 : 0);
        }
        int scan_idx = SCAN_DIAG;
        if (cu_pred_mode == MODE_INTRA &&
            (log2_tr == 2 || (log2_tr == 3 && c_idx == 0) ||
             (log2_tr == 3 && P.chroma_format_idc == 3))) {
            if (pred_mode_intra >= 6 && pred_mode_intra <= 14)
                scan_idx = SCAN_VERT;
            else if (pred_mode_intra >= 22 && pred_mode_intra <= 30)
                scan_idx = SCAN_HORIZ;
        }
        int last_x = last_sig_prefix(c_idx, log2_tr, CTX_LAST_SIG_COEFF_X_PREFIX);
        int last_y = last_sig_prefix(c_idx, log2_tr, CTX_LAST_SIG_COEFF_Y_PREFIX);
        if (last_x > 3) {
            int n = (last_x >> 1) - 1;
            last_x = (1 << n) * (2 + (last_x & 1)) + cab.bypass_bits(n);
        }
        if (last_y > 3) {
            int n = (last_y >> 1) - 1;
            last_y = (1 << n) * (2 + (last_y & 1)) + cab.bypass_bits(n);
        }
        if (scan_idx == SCAN_VERT) { int t = last_x; last_x = last_y; last_y = t; }
        int ncg = size >> 2;
        const uint8_t* cg_scan;
        const uint8_t* off_scan;
        switch (scan_idx) {
        case SCAN_HORIZ: off_scan = SCAN4_HORIZ; break;
        case SCAN_VERT:  off_scan = SCAN4_VERT; break;
        default:         off_scan = SCAN4_DIAG; break;
        }
        static const uint8_t one_cg[2] = {0, 0};
        if (ncg <= 1) cg_scan = one_cg;
        else if (ncg == 2) cg_scan = scan_idx == SCAN_HORIZ ? SCANCG2_HORIZ :
                                     scan_idx == SCAN_VERT ? SCANCG2_VERT : SCANCG2_DIAG;
        else if (ncg == 4) cg_scan = scan_idx == SCAN_HORIZ ? SCANCG4_HORIZ :
                                     scan_idx == SCAN_VERT ? SCANCG4_VERT : SCANCG4_DIAG;
        else cg_scan = scan_idx == SCAN_HORIZ ? SCANCG8_HORIZ :
                       scan_idx == SCAN_VERT ? SCANCG8_VERT : SCANCG8_DIAG;
        // inverse scan lookups (precomputed, InvScans)
        const uint8_t* off_inv = INV_SC.off4[scan_idx];
        int x_cg_last = last_x >> 2, y_cg_last = last_y >> 2;
        int cg_inv = ncg > 1
            ? INV_SC.cg[scan_idx][log2_tr - 2][y_cg_last * 8 + x_cg_last]
            : 0;
        int num_coeff = off_inv[(last_y & 3) * 4 + (last_x & 3)] +
                        (cg_inv << 4) + 1;
        int num_last_subset = (num_coeff - 1) >> 4;
        uint8_t csbf[64];
        memset(csbf, 0, sizeof(csbf));
        int g1_carry = 1;
        for (int i = num_last_subset; i >= 0; i--) {
            int x_cg = cg_scan[i * 2], y_cg = cg_scan[i * 2 + 1];
            int offset = i << 4;
            int implicit_nz = 0;
            if (i < num_last_subset && i > 0) {
                int ctx_cg = 0;
                if (x_cg < ncg - 1) ctx_cg += csbf[y_cg * 8 + x_cg + 1];
                if (y_cg < ncg - 1) ctx_cg += csbf[(y_cg + 1) * 8 + x_cg];
                int inc = imin(ctx_cg, 1) + (c_idx ? 2 : 0);
                csbf[y_cg * 8 + x_cg] =
                    (uint8_t)bin(CTX_CODED_SUB_BLOCK_FLAG, inc);
                implicit_nz = 1;
            } else {
                csbf[y_cg * 8 + x_cg] =
                    (x_cg == x_cg_last && y_cg == y_cg_last) ||
                    (x_cg == 0 && y_cg == 0);
            }
            int last_scan_pos = num_coeff - offset - 1;
            int sig_idx[16];
            int n_sig = 0;
            int n_end;
            if (i == num_last_subset) {
                n_end = last_scan_pos - 1;
                sig_idx[n_sig++] = last_scan_pos;
            } else n_end = 15;
            int prev_sig = 0;
            if (x_cg < ((size - 1) >> 2)) prev_sig = csbf[y_cg * 8 + x_cg + 1];
            if (y_cg < ((size - 1) >> 2))
                prev_sig += csbf[(y_cg + 1) * 8 + x_cg] << 1;
            if (csbf[y_cg * 8 + x_cg] && n_end >= 0) {
                int map_row, base_off;
                if (c_idx == 0) {
                    base_off = 0;
                    if (log2_tr == 2) map_row = 0;
                    else {
                        map_row = prev_sig + 1;
                        if (x_cg > 0 || y_cg > 0) base_off += 3;
                        base_off += log2_tr == 3
                                        ? (scan_idx == SCAN_DIAG ? 9 : 15)
                                        : 21;
                    }
                } else {
                    base_off = 27;
                    if (log2_tr == 2) map_row = 0;
                    else { map_row = prev_sig + 1;
                           base_off += log2_tr == 3 ? 9 : 12; }
                }
                // per-(scan, map_row) context increments in scan order,
                // precomputed once (SIG_INC below): the sig-flag loop
                // is the hottest bin loop in the parse — drop the
                // two scan-position loads + map lookup per bin
                const uint8_t* si =
                    sig_inc_lut(scan_idx) + map_row * 16;
                uint8_t* base_ctx = ctx + CTX_SIG_COEFF_FLAG + base_off;
                for (int n = n_end; n > 0; n--) {
                    if (cab.decode_bin(base_ctx, si[n])) {
                        sig_idx[n_sig++] = n;
                        implicit_nz = 0;
                    }
                }
                if (!implicit_nz) {
                    int dc_off = i == 0 ? (c_idx == 0 ? 0 : 27)
                                        : 2 + base_off;
                    if (bin(CTX_SIG_COEFF_FLAG, dc_off)) sig_idx[n_sig++] = 0;
                } else sig_idx[n_sig++] = 0;
            }
            if (!n_sig) continue;
            int ctx_set = (i > 0 && c_idx == 0) ? 2 : 0;
            if (i != num_last_subset && g1_carry == 0) ctx_set++;
            int g1 = 1;
            int gt1[8];
            int first_g1 = -1;
            int lim = imin(n_sig, 8);
            for (int m = 0; m < lim; m++) {
                int inc = (ctx_set << 2) + g1 + (c_idx ? 16 : 0);
                int fl = bin(CTX_COEFF_ABS_LEVEL_GREATER1_FLAG, inc);
                gt1[m] = fl;
                if (fl) { g1 = 0; if (first_g1 < 0) first_g1 = m; }
                else if (g1 > 0 && g1 < 3) g1++;
            }
            g1_carry = g1;
            int last_nz = sig_idx[0], first_nz = sig_idx[n_sig - 1];
            bool hidden;
            if (cu_tqb) hidden = false;
            else if (cu_pred_mode == MODE_INTRA && P.implicit_rdpcm &&
                     transform_skip &&
                     (pred_mode_intra == 10 || pred_mode_intra == 26))
                hidden = false;
            else hidden = (last_nz - first_nz) >= 4;
            if (first_g1 >= 0) {
                int inc = ctx_set + (c_idx ? 4 : 0);
                gt1[first_g1] += bin(CTX_COEFF_ABS_LEVEL_GREATER2_FLAG, inc);
            }
            int nb_signs = n_sig - ((P.sign_data_hiding && hidden) ? 1 : 0);
            uint32_t sign_bits = nb_signs
                ? (cab.bypass_bits(nb_signs) << (16 - nb_signs)) : 0;
            // persistent Rice adaptation (9.3.3.13; syntax.py:1244):
            // per-CG init from StatCoeff, one stat update on the first
            // coded remainder, no +1 cap while adapting
            const int price = P.persistent_rice;
            const int sb_type = (c_idx == 0 ? 2 : 0) +
                ((transform_skip || cu_tqb) ? 1 : 0);
            int rice = price ? (stat_coeff()[sb_type] >> 2) : 0;
            int rice_done = 0;
            auto bump = [&](int rem) {
                if (price && !rice_done) {
                    int r0 = stat_coeff()[sb_type] >> 2;
                    if (rem >= (3 << r0)) stat_coeff()[sb_type]++;
                    else if (2 * rem < (1 << r0) && stat_coeff()[sb_type])
                        stat_coeff()[sb_type]--;
                    rice_done = 1;
                }
            };
            int sum_abs = 0;
            for (int m = 0; m < n_sig; m++) {
                int n = sig_idx[m];
                int xc = (x_cg << 2) + off_scan[n * 2];
                int yc = (y_cg << 2) + off_scan[n * 2 + 1];
                int level;
                if (m < 8) {
                    level = 1 + gt1[m];
                    if (level == (m == first_g1 ? 3 : 2)) {
                        int rem = abs_level_remaining(rice);
                        level += rem;
                        if (level > (3 << rice))
                            rice = price ? rice + 1 : imin(rice + 1, 4);
                        bump(rem);
                    }
                } else {
                    int rem = abs_level_remaining(rice);
                    level = 1 + rem;
                    if (level > (3 << rice))
                        rice = price ? rice + 1 : imin(rice + 1, 4);
                    bump(rem);
                }
                if (P.sign_data_hiding && hidden) {
                    sum_abs += level;
                    if (n == first_nz && (sum_abs & 1)) level = -level;
                }
                if (sign_bits >> 15) level = -level;
                sign_bits = (sign_bits << 1) & 0xFFFF;
                if (level > blk_maxa) blk_maxa = level;
                else if (-level > blk_maxa) blk_maxa = -level;
                levels[yc * size + xc] = (int16_t)level;
            }
        }
        // qp
        int qp;
        if (c_idx == 0) qp = cu_qp + P.qp_bd_offset;
        else {
            int off = c_idx == 1
                ? P.cb_qp_offset + P.slice_cb_qp_offset + cu_qp_off_cb
                : P.cr_qp_offset + P.slice_cr_qp_offset + cu_qp_off_cr;
            int qpi = iclip(cu_qp + off, -P.qp_bd_offset, 57);
            int q;
            if (P.chroma_format_idc == 1) {
                if (qpi < 30) q = qpi;
                else if (qpi > 43) q = qpi - 6;
                else q = CHROMA_QP_TABLE[qpi - 30];
            } else q = imin(qpi, 51);
            qp = q + P.qp_bd_offset;
        }
        int is_dst = (cu_pred_mode == MODE_INTRA && c_idx == 0 &&
                      log2_tr == 2) ? 1 : 0;
        // transform-skip rotation: 4x4 intra TS blocks decode in
        // reversed scan (hevc_cabac.c:1877; syntax.py:1303)
        if (P.ts_rotation && log2_tr == 2 && cu_pred_mode == MODE_INTRA &&
            transform_skip && !cu_tqb) {
            for (int i = 0; i < 8; i++) {
                int16_t t = levels[i];
                levels[i] = levels[15 - i];
                levels[15 - i] = t;
            }
        }
        // RDPCM gates mirror syntax.py:1312-1328 (incl. the reference's
        // rotation-flag gate on the TS implicit path)
        int rdpcm_mode = -1;
        int intra_1026 = cu_pred_mode == MODE_INTRA &&
            (pred_mode_intra == 10 || pred_mode_intra == 26);
        if (cu_tqb) {
            if (explicit_rd >= 0 || (P.implicit_rdpcm && intra_1026))
                rdpcm_mode = P.implicit_rdpcm
                    ? (pred_mode_intra == 26 ? 1 : 0) : explicit_rd;
        } else if (transform_skip) {
            if (explicit_rd >= 0 || (P.ts_rotation && intra_1026))
                rdpcm_mode = explicit_rd >= 0 ? explicit_rd
                    : (pred_mode_intra == 26 ? 1 : 0);
        }
        int flags = (is_dst ? 1 : 0) | (transform_skip ? 2 : 0) |
                    (cu_tqb ? 4 : 0) | (rdpcm_mode >= 0 ? 8 : 0) |
                    (rdpcm_mode == 1 ? 16 : 0) |
                    (cu_pred_mode != MODE_INTRA ? 32 : 0) |
                    // cross_scale biased by 9 so 0 strictly means "no
                    // CCP" (scale itself spans [-8, 8]; 0 not emitted)
                    (cross_scale ? (cross_scale + 9) << 6 : 0);
        int32_t* meta = O->cb_meta + O->n_cb * 8;
        meta[0] = c_idx; meta[1] = x0; meta[2] = y0; meta[3] = log2_tr;
        meta[4] = qp; meta[5] = flags; meta[6] = O->lvl_used;
        meta[7] = blk_maxa;    // escape-free blocks take the fast pack path
        O->lvl_used += size * size;
        O->n_cb++;
    }

    int last_sig_prefix(int c_idx, int log2_tr, int base) {
        int ctx_offset, ctx_shift;
        if (c_idx == 0) {
            ctx_offset = 3 * (log2_tr - 2) + ((log2_tr - 1) >> 2);
            ctx_shift = (log2_tr + 1) >> 2;
        } else { ctx_offset = 15; ctx_shift = log2_tr - 2; }
        int i = 0, mx = (log2_tr << 1) - 1;
        while (i < mx && bin(base, (i >> ctx_shift) + ctx_offset)) i++;
        return i;
    }

    int abs_level_remaining(int rice) {
        int prefix = 0;
        while (prefix < 32 && cab.bypass()) prefix++;
        if (prefix < 3) {
            int suffix = rice ? cab.bypass_bits(rice) : 0;
            return (prefix << rice) + suffix;
        }
        int pm3 = prefix - 3;
        int suffix = cab.bypass_bits(pm3 + rice);
        return (((1 << pm3) + 2) << rice) + suffix;
    }
};

}  // namespace

extern "C" {

namespace {

// Worker-local append arenas for threaded substream parsing: grids stay
// shared (disjoint per-CTB writes), list outputs go to per-worker buffers
// and are merged back in substream order afterwards.
struct LocalOut {
    // uninitialized raw arrays (the parse writes every used prefix);
    // zero-filling ~9 MB/worker/frame would eat the threading win
    std::unique_ptr<int32_t[]> cb_meta, ij_meta, pcm_meta, pb;
    std::unique_ptr<int16_t[]> cb_levels;
    std::unique_ptr<uint8_t[]> ij_avail;
    std::unique_ptr<uint16_t[]> pcm_samples;
    Outputs o;
    struct Seg {
        int ss, cb0, cb1, ij0, ij1, pcm0, pcm1, pb0, pb1, lvl0, lvl1,
            ps0, ps1;
    };
    std::vector<Seg> segs;

    void init_from(const Outputs* base) {
        o = *base;                      // grids + caps copied
        cb_meta.reset(new int32_t[(size_t)base->cb_cap * 8]);
        cb_levels.reset(new int16_t[base->lvl_cap]);
        ij_meta.reset(new int32_t[(size_t)base->ij_cap * 8]);
        ij_avail.reset(new uint8_t[(size_t)base->ij_cap * 132]);
        pcm_meta.reset(new int32_t[(size_t)base->pcm_cap * 3]);
        pcm_samples.reset(new uint16_t[base->pcm_arena_cap]);
        pb.reset(new int32_t[(size_t)base->pb_cap * 14]);
        o.cb_meta = cb_meta.get();
        o.cb_levels = cb_levels.get();
        o.ij_meta = ij_meta.get();
        o.ij_avail = ij_avail.get();
        o.pcm_meta = pcm_meta.get();
        o.pcm_samples = pcm_samples.get();
        o.pb = pb.get();
        o.n_cb = o.n_ij = o.n_pcm = o.n_pb = 0;
        o.lvl_used = o.pcm_used = 0;
        o.error = 0;
    }
    void mark_start(int ss) {
        Seg s;
        s.ss = ss;
        s.cb0 = o.n_cb; s.ij0 = o.n_ij; s.pcm0 = o.n_pcm; s.pb0 = o.n_pb;
        s.lvl0 = o.lvl_used; s.ps0 = o.pcm_used;
        segs.push_back(s);
    }
    void mark_end() {
        Seg& s = segs.back();
        s.cb1 = o.n_cb; s.ij1 = o.n_ij; s.pcm1 = o.n_pcm; s.pb1 = o.n_pb;
        s.lvl1 = o.lvl_used; s.ps1 = o.pcm_used;
    }
};

bool merge_locals(std::vector<LocalOut>& locals, int nss, Outputs* out) {
    for (int ss = 0; ss < nss; ss++) {
        const LocalOut* lo = nullptr;
        const LocalOut::Seg* sg = nullptr;
        for (const auto& l : locals)
            for (const auto& s : l.segs)
                if (s.ss == ss) { lo = &l; sg = &s; }
        if (!sg) return false;
        int ncb = sg->cb1 - sg->cb0, nij = sg->ij1 - sg->ij0;
        int npcm = sg->pcm1 - sg->pcm0, npb = sg->pb1 - sg->pb0;
        int nlvl = sg->lvl1 - sg->lvl0, nps = sg->ps1 - sg->ps0;
        if (out->n_cb + ncb > out->cb_cap ||
            out->lvl_used + nlvl > out->lvl_cap ||
            out->n_ij + nij > out->ij_cap ||
            out->n_pcm + npcm > out->pcm_cap ||
            out->pcm_used + nps > out->pcm_arena_cap ||
            out->n_pb + npb > out->pb_cap)
            return false;
        int32_t* dst_cb = out->cb_meta + (size_t)out->n_cb * 8;
        memcpy(dst_cb, lo->cb_meta.get() + (size_t)sg->cb0 * 8,
               (size_t)ncb * 8 * sizeof(int32_t));
        int lvl_rebase = out->lvl_used - sg->lvl0;
        for (int i = 0; i < ncb; i++) dst_cb[i * 8 + 6] += lvl_rebase;
        memcpy(out->cb_levels + out->lvl_used,
               lo->cb_levels.get() + sg->lvl0, nlvl * sizeof(int16_t));
        memcpy(out->ij_meta + (size_t)out->n_ij * 8,
               lo->ij_meta.get() + (size_t)sg->ij0 * 8,
               (size_t)nij * 8 * sizeof(int32_t));
        memcpy(out->ij_avail + (size_t)out->n_ij * 132,
               lo->ij_avail.get() + (size_t)sg->ij0 * 132,
               (size_t)nij * 132);
        memcpy(out->pcm_meta + (size_t)out->n_pcm * 3,
               lo->pcm_meta.get() + (size_t)sg->pcm0 * 3,
               (size_t)npcm * 3 * sizeof(int32_t));
        memcpy(out->pcm_samples + out->pcm_used,
               lo->pcm_samples.get() + sg->ps0, nps * sizeof(uint16_t));
        memcpy(out->pb + (size_t)out->n_pb * 14,
               lo->pb.get() + (size_t)sg->pb0 * 14,
               (size_t)npb * 14 * sizeof(int32_t));
        out->n_cb += ncb; out->lvl_used += nlvl;
        out->n_ij += nij; out->n_pcm += npcm; out->pcm_used += nps;
        out->n_pb += npb;
    }
    return true;
}

}  // namespace

int hevc_parse_slice(const uint8_t* rbsp, int64_t size,
                     const SliceParams* params, Outputs* out,
                     const uint8_t* col_pf, const int32_t* col_mv,
                     const int32_t* col_rp) {
    // copy into a zero-padded buffer: the bit-cache refill then needs no
    // stream-end masking (past-end bits read as 0, as the spec's
    // bit-serial engine would)
    static thread_local std::vector<uint8_t> padded;
    padded.resize(size + RBSP_PAD);
    memcpy(padded.data(), rbsp, size);
    memset(padded.data() + size, 0, RBSP_PAD);
    out->n_cb = out->n_ij = out->n_pcm = out->n_pb = 0;
    out->lvl_used = out->pcm_used = 0;
    out->error = 0;
    out->threads = 1;
    out->fallback = 0;
    out->wave_wait_us = 0;

    Shared S;
    S.init(params, out, padded.data(), size);
    S.col_pf = col_pf;
    S.col_mv = col_mv;
    S.col_rp = col_rp;

    // ---- threaded substream parse (WPP rows / tiles) --------------------
    int nss = params->num_substreams;
    unsigned hw = std::thread::hardware_concurrency();
    int T = (int)(hw ? (hw > 4 ? 4 : hw) : 1);
    if (const char* e = getenv("OPENHEVC_PARSE_THREADS")) {
        int v = atoi(e);
        if (v >= 1 && v <= 16) T = v;
    }
    if (params->parse_threads >= 1 && params->parse_threads <= 16)
        T = params->parse_threads;    // per-decoder knob wins over env
    bool wpp_mode = S.wpp && !S.tiles && nss == S.ctbs_h;
    int ntiles = S.tiles ? params->num_tile_cols * params->num_tile_rows
                         : 1;
    bool tile_mode = S.tiles && !S.wpp && nss == ntiles;
    if (params->persistent_rice) T = 1;   // serial StatCoeff chain
    if (nss >= 2 && nss <= 128 && T >= 2 && (wpp_mode || tile_mode)) {
        if (T > nss) T = nss;
        if (wpp_mode) {
            S.row_progress.reset(new std::atomic<int>[nss]);
            S.snapshot_ready.reset(new std::atomic<int>[nss]);
            for (int r = 0; r < nss; r++) {
                S.row_progress[r].store(0);
                S.snapshot_ready[r].store(0);
            }
            S.row_snapshot.resize(nss);
        }
        // tile ts ranges (tiles are contiguous in tile-scan order)
        std::vector<int> tile_begin(ntiles + 1, 0);
        if (tile_mode) {
            for (int ts = 0; ts < (int)S.ts_order.size(); ts++)
                tile_begin[S.tile_id[S.ts_order[ts]] + 1] = ts + 1;
        }
        std::vector<LocalOut> locals(T);
        std::vector<int64_t> wait_ns(T, 0);
        auto worker = [&](int tid) {
            locals[tid].init_from(out);
            for (int ss = tid; ss < nss; ss += T) {
                if (S.any_err.load(std::memory_order_relaxed)) break;
                locals[tid].mark_start(ss);
                Parser p;
                p.bind(S, &locals[tid].o);
                int64_t bit = (int64_t)params->ss_start[ss] * 8;
                int rc = wpp_mode
                    ? p.decode_wpp_row(ss, bit)
                    : p.decode_tile(tile_begin[ss], tile_begin[ss + 1],
                                    bit);
                wait_ns[tid] += p.wait_ns;
                locals[tid].mark_end();
                if (rc) break;
            }
        };
        std::vector<std::thread> threads;
        for (int t = 1; t < T; t++) threads.emplace_back(worker, t);
        worker(0);
        for (auto& th : threads) th.join();
        int64_t waited = 0;
        for (int64_t w : wait_ns) waited += w;
        out->threads = T;
        out->wave_wait_us = waited / 1000;
        if (!S.any_err.load() && merge_locals(locals, nss, out))
            return 0;
        // threaded parse failed: reset and fall through to the serial
        // path for exact serial error behavior
        out->n_cb = out->n_ij = out->n_pcm = out->n_pb = 0;
        out->lvl_used = out->pcm_used = 0;
        out->error = 0;
        S.any_err.store(false);
        Shared S2;
        S2.init(params, out, padded.data(), size);
        S2.col_pf = col_pf;
        S2.col_mv = col_mv;
        S2.col_rp = col_rp;
        Parser p;
        p.bind(S2, out);
        p.cab.reinit((int64_t)params->data_start_byte * 8);
        p.init_ctx_states(S2.init_type);
        int rc = p.decode();
        if (rc) out->error = 1;
        out->fallback = 1;
        return rc;
    }

    // ---- serial parse ----------------------------------------------------
    Parser p;
    p.bind(S, out);
    p.cab.reinit((int64_t)params->data_start_byte * 8);
    p.init_ctx_states(S.init_type);
    int rc = p.decode();
    if (!rc && p.end_ts != S.ctbs_w * S.ctbs_h) rc = -1;
    if (rc) out->error = 1;
    return rc;
}

// Multi-slice picture parse: segments chained in decode order (CABAC
// context + QP state carry across dependent segments; independent
// slices re-init). Serial only — the threaded substream path applies to
// single-slice pictures. Mirrors decoder.py's Python accumulation
// (hls_slice_data per segment, hevc.c:3017).
int hevc_parse_picture(int n_seg, const uint8_t* const* rbsps,
                       const int64_t* sizes, const SliceParams* params,
                       Outputs* out, const uint8_t* col_pf,
                       const int32_t* col_mv, const int32_t* col_rp) {
    if (n_seg < 1) return -1;
    std::vector<std::vector<uint8_t>> padded((size_t)n_seg);
    for (int i = 0; i < n_seg; i++) {
        padded[i].resize(sizes[i] + RBSP_PAD);
        memcpy(padded[i].data(), rbsps[i], sizes[i]);
        memset(padded[i].data() + sizes[i], 0, RBSP_PAD);
    }
    out->n_cb = out->n_ij = out->n_pcm = out->n_pb = 0;
    out->lvl_used = out->pcm_used = 0;
    out->error = 0;
    out->threads = 1;
    out->fallback = 0;
    out->wave_wait_us = 0;
    Shared S;
    S.init(&params[0], out, padded[0].data(), sizes[0]);
    S.col_pf = col_pf;
    S.col_mv = col_mv;
    S.col_rp = col_rp;
    int n_ctb = S.ctbs_w * S.ctbs_h;
    std::unique_ptr<Parser> prev;
    int expect_ts = 0;
    for (int i = 0; i < n_seg; i++) {
        if (params[i].start_ts != expect_ts) { out->error = 1; return -1; }
        S.P = &params[i];
        S.rbsp = padded[i].data();
        S.size = sizes[i];
        auto pr = std::unique_ptr<Parser>(new Parser());
        pr->bind(S, out);
        pr->cab.reinit((int64_t)params[i].data_start_byte * 8);
        if (params[i].dependent && prev) {
            // 7.4.7.1: dependent segment continues the slice — CABAC
            // contexts and QP-prediction state carry over
            memcpy(pr->ctx, prev->ctx, CTX_STATE_BYTES);
            pr->qp_y = prev->qp_y;
            pr->qPy_pred = prev->qPy_pred;
            pr->cu_qp = pr->qp_y;
            pr->first_qp_group = false;
        } else {
            int it = params[i].slice_type == 2
                ? 0 : (params[i].slice_type == 1 ? 1 : 2);
            if (params[i].cabac_init_present && params[i].cabac_init_flag &&
                params[i].slice_type != 2)
                it = 3 - it;
            pr->init_ctx_states(it);
        }
        int rc = pr->decode();
        if (rc || pr->end_ts <= params[i].start_ts) {
            out->error = 1;
            return -1;
        }
        expect_ts = pr->end_ts;
        prev = std::move(pr);
    }
    if (expect_ts != n_ctb) { out->error = 1; return -1; }
    return 0;
}

int hevc_parse_abi_version() { return 5; }

// ---------------------------------------------------------------------------
// Frame packing: convert the parse outputs (cb_meta/cb_levels decode-order
// lists + intra-job list) into the exact device-upload layouts consumed by
// models/pipeline.py::_frame_fused — the per-size residual arenas (4-bit
// biased-nibble levels + 3-int16-per-block sideband + int32 escape pairs)
// and the transposed [8, npad] int16 intra meta of
// ops/intra_fused.py::pack_meta (derived rows are rebuilt on device).
// Mirrors the Python packers field-for-field (they stay as the correctness
// cross-check); the shared ~55 MB/s host<->device wire is the decode
// bottleneck, hence the byte-pinching formats.
// ---------------------------------------------------------------------------

namespace {

const int PACK_SIZES[4] = {4, 8, 16, 32};
const int PACK_FAR = -(1 << 14);
const int PACK_OY = 8, PACK_OX = 128;

}  // namespace

// Returns 0 on success, -1 if any output buffer is too small (caller
// reallocates and retries). caps_out: 4 x (s, cap, has_sm, n_esc);
// used_out: {arena8_used, arena16_used, esc_used, npad}.
// geometric shape bucket (pow2 and 1.5*pow2 steps): bounds the jit
// signature count of the device programs to ~2 per octave while
// wasting <= 33% padded rows (padding is nibble-cheap on the wire)
static int32_t round_bucket(int32_t n, int32_t base) {
    if (n <= base) return base;
    int32_t p = base;
    while (p < n) p <<= 1;
    int32_t half = p >> 1;
    int32_t mid = half + (half >> 1);
    return (n <= mid) ? mid : p;
}

// 1/16-octave bucket (mirrors models/pipeline.py::_round_fine): the big
// wire buffers round to a multiple of 2^(floor(log2 n)-4) instead of the
// coarse pow2/1.5-pow2 steps — <= ~6% padding, 16 static shapes/octave.
static int32_t round_fine(int32_t n, int32_t base) {
    if (n <= base) return base;
    int bl = 32 - __builtin_clz((uint32_t)(n - 1));  // bit_length(n-1)
    int sh = bl - 5 < 0 ? 0 : bl - 5;
    int32_t step = 1 << sh;
    return (n + step - 1) / step * step;
}

// Raster index of scan position i for the size-class si TU (up-right
// diagonal 4x4 coefficient groups, diagonal within each group — the
// ops/coeff_scan.py tables, mirrored). Built once.
static const int32_t* pack_scan_lut(int si) {
    static int32_t luts[4][1024];
    static bool init = false;
    if (!init) {
        for (int c = 0; c < 4; c++) {
            const int sz = PACK_SIZES[c];
            const int ncg = sz / 4;
            int cgx[64], cgy[64], ix[16], iy[16];
            // up-right diagonal order over an n x n grid
            for (int pass = 0; pass < 2; pass++) {
                const int n = pass ? 4 : ncg;
                int* xs = pass ? ix : cgx;
                int* ys = pass ? iy : cgy;
                int cnt = 0, x = 0, y = 0;
                while (cnt < n * n) {
                    while (y >= 0) {
                        if (x < n && y < n) { xs[cnt] = x; ys[cnt] = y;
                                              cnt++; }
                        y--; x++;
                    }
                    y = x; x = 0;
                }
            }
            int i = 0;
            for (int g = 0; g < ncg * ncg; g++)
                for (int j = 0; j < 16; j++)
                    luts[c][i++] = (cgy[g] * 4 + iy[j]) * sz +
                                   cgx[g] * 4 + ix[j];
        }
        init = true;
    }
    return luts[si];
}

int hevc_pack_frame(
        const int32_t* cb_meta, int32_t n_cb, const int16_t* cb_levels,
        const int32_t* ij_meta, const uint8_t* ij_avail, int32_t n_ij,
        int32_t strong_smoothing,
        uint8_t* arena4, int32_t arena4_cap,
        int16_t* arena16, int32_t arena16_cap,
        int32_t* esc, int32_t esc_cap,
        int16_t* meta, int32_t meta_cap,
        int32_t* caps_out, int32_t* used_out) {
    (void)strong_smoothing;   // derived on device now
    // ---- residual buckets (v2 scan-prefix payload format) -------------
    // Per TU ship only the scan-order prefix up to the last significant
    // coefficient, as biased nibbles (+ escapes) or biased bytes —
    // whichever is fewer bytes. Sideband: bx, by, qpf, cnt|mode<<12.
    // Mirrors models/pipeline.py::_pack_arena byte-for-byte.
    int32_t o4 = 0, o16 = 0, oe = 0;   // o4 = payload BYTES
    for (int si = 0; si < 4; si++) {
        const int s = PACK_SIZES[si];
        const int log2s = 2 + si, ss = s * s;
        const int32_t* scan = pack_scan_lut(si);
        // bucket-local selection (decode order preserved)
        int n = 0;
        for (int i = 0; i < n_cb; i++) n += (cb_meta[i * 8 + 3] == log2s);
        if (n == 0) {
            caps_out[si * 4 + 0] = s;
            caps_out[si * 4 + 1] = 0;
            caps_out[si * 4 + 2] = 0;
            caps_out[si * 4 + 3] = 0;
            continue;
        }
        const int cap = round_bucket(n, 256);
        if (o16 + 4 * cap > arena16_cap) return -1;
        int16_t* bx = arena16 + o16;
        int16_t* by = bx + cap;
        int16_t* qf = by + cap;
        int16_t* cw = qf + cap;
        int esc_start = oe;
        int j = 0;
        for (int i = 0; i < n_cb; i++) {
            const int32_t* m = cb_meta + i * 8;
            if (m[3] != log2s) continue;
            const int16_t* src = cb_levels + m[6];
            // last significant coefficient in scan order
            int cnt = 0;
            for (int k = ss - 1; k >= 0; k--)
                if (src[scan[k]] != 0) { cnt = k + 1; break; }
            // mode choice by exact byte cost (escapes are 8 B each)
            int byte_mode = 0;
            if (m[7] > 7) {            // max |level| from parse
                int e7 = 0, e127 = 0;
                for (int k = 0; k < cnt; k++) {
                    const int v = src[scan[k]];
                    e7 += (v < -8) | (v > 7);
                    e127 += (v < -128) | (v > 127);
                }
                byte_mode = (cnt + 8 * e127) < ((cnt + 1) / 2 + 8 * e7);
            }
            const int plen = byte_mode ? cnt : (cnt + 1) / 2;
            if (o4 + plen > arena4_cap) return -1;
            uint8_t* dst = arena4 + o4;
            const int base = j * ss;
            if (byte_mode) {
                for (int k = 0; k < cnt; k++) {
                    const int v = src[scan[k]];
                    const int c = v < -128 ? -128 : (v > 127 ? 127 : v);
                    dst[k] = (uint8_t)(c + 128);
                    if (v != c) {
                        if (oe + 2 > esc_cap) return -1;
                        esc[oe++] = base + scan[k];
                        esc[oe++] = v - c;
                    }
                }
            } else {
                for (int k = 0; k < cnt; k += 2) {
                    const int v0 = src[scan[k]];
                    const int v1 = (k + 1 < cnt) ? src[scan[k + 1]] : 0;
                    const int c0 = v0 < -8 ? -8 : (v0 > 7 ? 7 : v0);
                    const int c1 = v1 < -8 ? -8 : (v1 > 7 ? 7 : v1);
                    dst[k >> 1] = (uint8_t)((c0 + 8) | ((c1 + 8) << 4));
                    if (v0 != c0) {
                        if (oe + 2 > esc_cap) return -1;
                        esc[oe++] = base + scan[k];
                        esc[oe++] = v0 - c0;
                    }
                    if (v1 != c1) {
                        if (oe + 2 > esc_cap) return -1;
                        esc[oe++] = base + scan[k + 1];
                        esc[oe++] = v1 - c1;
                    }
                }
            }
            o4 += plen;
            bx[j] = (int16_t)m[1];
            by[j] = (int16_t)m[2];
            cw[j] = (int16_t)(cnt | (byte_mode << 12));
            const int f = m[5];
            // qp<<7 | has_rdpcm<<6 | rdpcm_vert<<5 | tqb<<4 | ts<<3 |
            // dst<<2 | plane
            qf[j] = (int16_t)((m[4] << 7) |
                              (((f >> 3) & 1) << 6) |   // has_rdpcm (bit 8)
                              (((f >> 4) & 1) << 5) |   // rdpcm_vert (16)
                              (((f >> 2) & 1) << 4) |   // tqb (4)
                              (((f >> 1) & 1) << 3) |   // ts (2)
                              ((f & 1) << 2) |          // dst (1)
                              m[0]);                    // plane
            j++;
        }
        // padding rows: qp/flags/plane zero, FAR coords, zero prefix
        for (int k = n; k < cap; k++) {
            qf[k] = 0;
            cw[k] = 0;
            bx[k] = (int16_t)PACK_FAR;
            by[k] = (int16_t)PACK_FAR;
        }
        // escape list padding to the 64-pair bucket (pairs of (-1, -1),
        // dropped by the device scatter), min 8 pairs — matches
        // _pack_arena's n_esc = max(8, ceil/64*64)
        int n_pairs = (oe - esc_start) / 2;
        int n_esc = 0;
        if (n_pairs) {
            n_esc = n_pairs <= 8 ? 8 : round_fine(n_pairs, 64);
            if (esc_start + 2 * n_esc > esc_cap) return -1;
            for (int k = n_pairs; k < n_esc; k++) {
                esc[esc_start + 2 * k] = -1;
                esc[esc_start + 2 * k + 1] = -1;
            }
            oe = esc_start + 2 * n_esc;
        }
        caps_out[si * 4 + 0] = s;
        caps_out[si * 4 + 1] = cap;
        caps_out[si * 4 + 2] = 0;          // scaling lists: Python path
        caps_out[si * 4 + 3] = n_esc;
        o16 += 4 * cap;
    }
    // ---- intra meta [5, npad] (ops/intra_fused.py pack_meta: y, x,
    // sl|plane<<2|mode<<4|av_hi<<10, av_w0, av_w1 — 10 B/job) ------------
    const int npad = round_fine(n_ij, 1024);
    if (5 * npad > meta_cap) return -1;
    memset(meta, 0, (size_t)5 * npad * sizeof(int16_t));
    for (int i = 0; i < n_ij; i++) {
        const int32_t* m = ij_meta + i * 8;
        const uint8_t* av = ij_avail + i * 132;
        const int plane = m[0], x = m[1], y = m[2], s = m[3], mode = m[4];
        int log2s = s == 4 ? 2 : s == 8 ? 3 : s == 16 ? 4 : 5;
        meta[0 * npad + i] = (int16_t)(y + PACK_OY);
        meta[1 * npad + i] = (int16_t)(x + PACK_OX);
        // availability group bits: [left s/2 | corner | top s/2], one bit
        // per 4-sample run (min-PU granularity)
        uint64_t gb = 0;
        int g = 0;
        for (int k = 0; k < s / 2; k++, g++)
            gb |= (uint64_t)(av[4 * k] != 0) << g;
        gb |= (uint64_t)(av[2 * s] != 0) << g; g++;
        for (int k = 0; k < s / 2; k++, g++)
            gb |= (uint64_t)(av[2 * s + 1 + 4 * k] != 0) << g;
        meta[2 * npad + i] = (int16_t)((log2s - 2) | (plane << 2) |
                                       (mode << 4) |
                                       (int)((gb >> 32) & 1) << 10);
        meta[3 * npad + i] = (int16_t)(uint16_t)(gb & 0xFFFF);
        meta[4 * npad + i] = (int16_t)(uint16_t)((gb >> 16) & 0xFFFF);
    }
    used_out[0] = o4;         // payload arena bytes used
    used_out[1] = o16;
    used_out[2] = oe;
    used_out[3] = npad;
    return 0;
}

}
