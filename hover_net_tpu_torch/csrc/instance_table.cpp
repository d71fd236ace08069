// Single-pass per-instance statistics over an int32 label map.
//
// The host finalization step (bbox / centroid / size / majority-vote
// type per nucleus) is the reference's per-instance Python+cv2 loop
// (models/hovernet/post_proc.py:120-181), which rescans the full map
// once per instance — O(instances * area). This kernel computes all
// per-instance tables in ONE pass over the map, O(area), and is called
// through ctypes (hover_net_tpu_torch/ops/instance_table.py).
//
// The port's own copy of native/instance_table.cpp, unchanged apart
// from this header: the port builds it into build/hover_net_tpu_torch/.
//
// Labels must be contiguous 1..n_labels (remap first). Type histogram
// is optional (pass nullptr).

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// out_bbox:     [n_labels, 4]  (rmin, rmax_excl, cmin, cmax_excl)
// out_sum_yx:   [n_labels, 2]  (sum_y, sum_x)  for centroids
// out_size:     [n_labels]
// out_type_hist:[n_labels, n_types]  (optional)
void instance_table(const int32_t* labels, const int32_t* type_map,
                    int64_t height, int64_t width, int32_t n_labels,
                    int32_t n_types, int64_t* out_bbox,
                    int64_t* out_sum_yx, int64_t* out_size,
                    int64_t* out_type_hist) {
    for (int32_t i = 0; i < n_labels; ++i) {
        out_bbox[i * 4 + 0] = height;  // rmin
        out_bbox[i * 4 + 1] = 0;       // rmax
        out_bbox[i * 4 + 2] = width;   // cmin
        out_bbox[i * 4 + 3] = 0;       // cmax
    }
    std::memset(out_sum_yx, 0, sizeof(int64_t) * (size_t)n_labels * 2);
    std::memset(out_size, 0, sizeof(int64_t) * (size_t)n_labels);
    if (out_type_hist && type_map) {
        std::memset(out_type_hist, 0,
                    sizeof(int64_t) * (size_t)n_labels * (size_t)n_types);
    }

    for (int64_t y = 0; y < height; ++y) {
        const int32_t* row = labels + y * width;
        const int32_t* trow = type_map ? type_map + y * width : nullptr;
        for (int64_t x = 0; x < width; ++x) {
            int32_t lab = row[x];
            if (lab <= 0 || lab > n_labels) continue;
            int64_t i = (int64_t)(lab - 1);
            int64_t* bb = out_bbox + i * 4;
            if (y < bb[0]) bb[0] = y;
            if (y + 1 > bb[1]) bb[1] = y + 1;
            if (x < bb[2]) bb[2] = x;
            if (x + 1 > bb[3]) bb[3] = x + 1;
            out_sum_yx[i * 2 + 0] += y;
            out_sum_yx[i * 2 + 1] += x;
            out_size[i] += 1;
            if (trow && out_type_hist) {
                int32_t t = trow[x];
                if (t >= 0 && t < n_types) {
                    out_type_hist[i * n_types + t] += 1;
                }
            }
        }
    }
}

// Relabel via a lookup table in place: labels[i] = lut[labels[i]].
// Used for contiguous-id remapping of big WSI maps without a Python
// fancy-indexing round trip.
void apply_lut(int32_t* labels, int64_t count, const int32_t* lut,
               int32_t lut_size) {
    for (int64_t i = 0; i < count; ++i) {
        int32_t v = labels[i];
        labels[i] = (v >= 0 && v < lut_size) ? lut[v] : 0;
    }
}

// Outer-boundary tracing of every instance in one call, replacing the
// per-instance Python loop of crop + cv2.findContours (the reference's
// contour extraction, models/hovernet/post_proc.py:140-143). Border
// following matches cv2's Suzuki-Abe outer border: start at each
// instance's first raster-order pixel, walk the 8-neighbourhood
// counterclockwise, and emit CHAIN_APPROX_SIMPLE-style compressed
// points (segment endpoints only).
//
// labels:     [h, w] int32 contiguous 1..n_labels
// bbox:       [n_labels, 4] (rmin, rmax_excl, cmin, cmax_excl) from
//             instance_table (start-pixel search is confined to it)
// out_points: [capacity, 2] int32 (x, y)
// out_offsets:[n_labels + 1] int64; label i's points occupy
//             out_points[out_offsets[i] : out_offsets[i+1]]
// Returns total points written, or -1 if capacity was exceeded (caller
// retries with a larger buffer; 8*area is always enough).
int64_t trace_contours(const int32_t* labels, int64_t h, int64_t w,
                       int32_t n_labels, const int64_t* bbox,
                       int32_t* out_points, int64_t capacity,
                       int64_t* out_offsets) {
    // clockwise 8-neighbourhood starting east, consistent with
    // OpenCV's deltas for border following
    static const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    static const int dx[8] = {1, 1, 0, -1, -1, -1, 0, 1};

    int64_t total = 0;
    out_offsets[0] = 0;
    for (int32_t li = 0; li < n_labels; ++li) {
        const int32_t lab = li + 1;
        const int64_t rmin = bbox[li * 4 + 0], rmax = bbox[li * 4 + 1];
        const int64_t cmin = bbox[li * 4 + 2], cmax = bbox[li * 4 + 3];
        // first raster-order pixel = cv2's outer-border start
        int64_t sy = -1, sx = -1;
        for (int64_t y = rmin; y < rmax && sy < 0; ++y) {
            const int32_t* row = labels + y * w;
            for (int64_t x = cmin; x < cmax; ++x) {
                if (row[x] == lab) { sy = y; sx = x; break; }
            }
        }
        if (sy < 0) { out_offsets[li + 1] = total; continue; }

        const int64_t run_start = total;
        // emit with CHAIN_APPROX_SIMPLE compression: a point is kept
        // when the incoming direction changes (plus first and last)
        int prev_dir = -2;
        int64_t py = -1, px = -1;  // last emitted
        int64_t ly = -1, lx = -1;  // last visited (pending)
        auto visit = [&](int64_t y, int64_t x, int dir) -> bool {
            if (dir != prev_dir) {
                // direction changed: the previous pending pixel is a
                // segment endpoint
                if (ly >= 0 && (ly != py || lx != px)) {
                    if (total >= capacity) return false;
                    out_points[total * 2 + 0] = (int32_t)lx;
                    out_points[total * 2 + 1] = (int32_t)ly;
                    ++total; py = ly; px = lx;
                }
                prev_dir = dir;
            }
            ly = y; lx = x;
            return true;
        };

        // single-pixel check: any 8-neighbour with same label?
        bool isolated = true;
        for (int k = 0; k < 8 && isolated; ++k) {
            int64_t ny = sy + dy[k], nx = sx + dx[k];
            if (ny >= 0 && ny < h && nx >= 0 && nx < w &&
                labels[ny * w + nx] == lab) isolated = false;
        }
        if (isolated) {
            if (total >= capacity) return -1;
            out_points[total * 2 + 0] = (int32_t)sx;
            out_points[total * 2 + 1] = (int32_t)sy;
            ++total;
            out_offsets[li + 1] = total;
            continue;
        }

        // Moore border following, counterclockwise like cv2's outer
        // borders: from the start pixel, search the neighbourhood
        // clockwise beginning just past the backtrack direction.
        // Initial backtrack: west (the pixel left of start is outside
        // the instance by construction).
        int64_t cy = sy, cx = sx;
        int back = 4;  // direction from current pixel towards backtrack
        // emit start pixel (capacity check BEFORE the write: a prior
        // label may have exactly filled the buffer)
        if (total >= capacity) return -1;
        out_points[total * 2 + 0] = (int32_t)sx;
        out_points[total * 2 + 1] = (int32_t)sy;
        ++total; py = sy; px = sx; ly = sy; lx = sx; prev_dir = -2;
        int first_move = -1;  // direction of the first step
        int64_t guard = 4 * (rmax - rmin + 2) * (cmax - cmin + 2) + 16;
        while (guard-- > 0) {
            int dir = -1;
            for (int k = 1; k <= 8; ++k) {
                int cand = (back + k) & 7;
                int64_t ny = cy + dy[cand], nx = cx + dx[cand];
                if (ny >= 0 && ny < h && nx >= 0 && nx < w &&
                    labels[ny * w + nx] == lab) { dir = cand; break; }
            }
            if (dir < 0) break;  // unreachable: not isolated
            // Jacob's stopping criterion: we are back at the start
            // pixel and about to repeat the initial move
            if (first_move >= 0 && cy == sy && cx == sx &&
                dir == first_move) break;
            if (first_move < 0) first_move = dir;
            cy += dy[dir]; cx += dx[dir];
            back = (dir + 4) & 7;
            if (!visit(cy, cx, dir)) return -1;
        }
        // flush the pending pixel (closes the polygon's last segment)
        if (ly >= 0 && (ly != py || lx != px) && !(ly == sy && lx == sx)) {
            if (total >= capacity) return -1;
            out_points[total * 2 + 0] = (int32_t)lx;
            out_points[total * 2 + 1] = (int32_t)ly;
            ++total;
        }
        (void)run_start;
        out_offsets[li + 1] = total;
    }
    return total;
}

// COO-based variant of trace_contours: the label map never leaves the
// device — only its boundary pixels do, as a sorted sparse table the
// TPU computes (ops/post_proc_device.instance_tables). Each entry
// carries the pixel's 8-neighbour same-label bitmask, so every
// neighbour query of the Suzuki-Abe walk is answered either from the
// current pixel's mask (is the neighbour in my instance?) or by a
// binary search within the instance's slice (fetch the mask after a
// move — every visited pixel has a non-same 8-neighbour, hence is in
// the table). Emits the same CHAIN_APPROX_SIMPLE chains as
// trace_contours / cv2.
//
// yx:   [n] int32 packed (y << 16) | x, in raster (y, x) order with
//       labels interleaved (a device cumsum+scatter compaction; a
//       device-side (label, y, x) sort would cost a ~1M-element
//       argsort per tile — the label grouping is restored here with an
//       O(n) stable counting sort, raster order preserved per label)
// lm:   [n] int32 packed (label << 8) | mask8, mask bit k = same-label
//       neighbour in direction k of the E,NE,N,NW,W,SW,S,SE table
// out_points: [capacity, 2] int32 (x, y)
// out_offsets:[n_labels + 1] int64
// Returns total points, -1 on capacity overflow, -2 on corrupt input.
int64_t trace_contours_coo(const int32_t* yx_in, const int32_t* lm_in,
                           int64_t n, int32_t n_labels,
                           int32_t* out_points, int64_t capacity,
                           int64_t* out_offsets) {
    static const int dy[8] = {0, -1, -1, -1, 0, 1, 1, 1};
    static const int dx[8] = {1, 1, 0, -1, -1, -1, 0, 1};

    // stable counting sort by label: [n] raster-ordered -> label slices
    std::vector<int32_t> syx((size_t)n), slm((size_t)n);
    {
        std::vector<int64_t> off((size_t)n_labels + 2, 0);
        for (int64_t i = 0; i < n; ++i) {
            int32_t lab = lm_in[i] >> 8;
            if (lab < 1 || lab > n_labels) return -2;
            ++off[(size_t)lab + 1];
        }
        for (size_t l = 1; l < off.size(); ++l) off[l] += off[l - 1];
        for (int64_t i = 0; i < n; ++i) {
            int64_t p = off[(size_t)(lm_in[i] >> 8)]++;
            syx[(size_t)p] = yx_in[i];
            slm[(size_t)p] = lm_in[i];
        }
    }
    const int32_t* yx = syx.data();
    const int32_t* lm = slm.data();

    int64_t total = 0;
    out_offsets[0] = 0;
    int64_t pos = 0;  // cursor into the (label-sorted) entries
    for (int32_t li = 0; li < n_labels; ++li) {
        const int32_t lab = li + 1;
        // this label's contiguous slice [i0, i1)
        while (pos < n && (lm[pos] >> 8) < lab) ++pos;
        const int64_t i0 = pos;
        while (pos < n && (lm[pos] >> 8) == lab) ++pos;
        const int64_t i1 = pos;
        if (i0 == i1) { out_offsets[li + 1] = total; continue; }

        // mask lookup by packed (y, x) within [i0, i1)
        auto mask_at = [&](int64_t y, int64_t x) -> int {
            int32_t key = (int32_t)((y << 16) | x);
            int64_t lo = i0, hi = i1;
            while (lo < hi) {
                int64_t mid = (lo + hi) >> 1;
                if (yx[mid] < key) lo = mid + 1; else hi = mid;
            }
            if (lo < i1 && yx[lo] == key) return lm[lo] & 0xff;
            return -1;  // not a boundary pixel (never hit by the walk)
        };

        // start = raster-first boundary pixel = cv2's start pixel
        const int64_t sy = yx[i0] >> 16, sx = yx[i0] & 0xffff;
        int mask = lm[i0] & 0xff;

        const int64_t run_start = total;
        int prev_dir = -2;
        int64_t py = -1, px = -1;
        int64_t ly = -1, lx = -1;
        auto visit = [&](int64_t y, int64_t x, int dir) -> bool {
            if (dir != prev_dir) {
                if (ly >= 0 && (ly != py || lx != px)) {
                    if (total >= capacity) return false;
                    out_points[total * 2 + 0] = (int32_t)lx;
                    out_points[total * 2 + 1] = (int32_t)ly;
                    ++total; py = ly; px = lx;
                }
                prev_dir = dir;
            }
            ly = y; lx = x;
            return true;
        };

        if (mask == 0) {  // isolated single pixel
            if (total >= capacity) return -1;
            out_points[total * 2 + 0] = (int32_t)sx;
            out_points[total * 2 + 1] = (int32_t)sy;
            ++total;
            out_offsets[li + 1] = total;
            continue;
        }

        int64_t cy = sy, cx = sx;
        int back = 4;  // initial backtrack: west
        if (total >= capacity) return -1;
        out_points[total * 2 + 0] = (int32_t)sx;
        out_points[total * 2 + 1] = (int32_t)sy;
        ++total; py = sy; px = sx; ly = sy; lx = sx; prev_dir = -2;
        int first_move = -1;
        int64_t guard = 4 * (i1 - i0) * 8 + 16;
        while (guard-- > 0) {
            int dir = -1;
            for (int k = 1; k <= 8; ++k) {
                int cand = (back + k) & 7;
                if (mask & (1 << cand)) { dir = cand; break; }
            }
            if (dir < 0) break;  // unreachable: mask != 0
            if (first_move >= 0 && cy == sy && cx == sx &&
                dir == first_move) break;
            if (first_move < 0) first_move = dir;
            cy += dy[dir]; cx += dx[dir];
            back = (dir + 4) & 7;
            mask = mask_at(cy, cx);
            if (mask < 0) return -2;  // walked off the boundary table
            if (!visit(cy, cx, dir)) return -1;
        }
        if (ly >= 0 && (ly != py || lx != px) && !(ly == sy && lx == sx)) {
            if (total >= capacity) return -1;
            out_points[total * 2 + 0] = (int32_t)lx;
            out_points[total * 2 + 1] = (int32_t)ly;
            ++total;
        }
        (void)run_start;
        out_offsets[li + 1] = total;
    }
    return total;
}

// 4-connected SAME-VALUE fragment labelling of an int32 annotation
// map: two pixels share a fragment iff 4-adjacent with equal nonzero
// value. This is the graph step of fix_mirror_padding (reference
// dataloader/augs.py:18-32) — mirrored shape augmentation duplicates
// instance ids, and each spatial fragment must become its own id. One
// union-find pass over the row/col edges replaces a scipy
// coo_matrix + csgraph.connected_components build (~6 ms -> <1 ms per
// 256^2 training sample on the loader hot path,
// hover_net_tpu/ops/targets.py).
//
// out: [h*w] int32, 0 on background, fragments numbered 1..F in order
// of each fragment's first raster pixel. Returns F.
int32_t fragment_labels(const int32_t* ann, int64_t h, int64_t w,
                        int32_t* out) {
    const int64_t n = h * w;
    std::vector<int32_t> parent((size_t)n);
    for (int64_t i = 0; i < n; ++i) parent[(size_t)i] = (int32_t)i;

    // iterative find with path halving
    auto find = [&](int32_t x) {
        while (parent[(size_t)x] != x) {
            parent[(size_t)x] = parent[(size_t)parent[(size_t)x]];
            x = parent[(size_t)x];
        }
        return x;
    };

    for (int64_t y = 0; y < h; ++y) {
        const int32_t* row = ann + y * w;
        for (int64_t x = 0; x < w; ++x) {
            int32_t v = row[x];
            if (v == 0) continue;
            int64_t i = y * w + x;
            if (x + 1 < w && row[x + 1] == v) {
                int32_t a = find((int32_t)i), b = find((int32_t)(i + 1));
                if (a != b) { if (a < b) parent[(size_t)b] = a;
                              else parent[(size_t)a] = b; }
            }
            if (y + 1 < h && row[x + w] == v) {
                int32_t a = find((int32_t)i), b = find((int32_t)(i + w));
                if (a != b) { if (a < b) parent[(size_t)b] = a;
                              else parent[(size_t)a] = b; }
            }
        }
    }

    // roots are raster-minimal (we always union toward the smaller
    // index), so numbering fragments at first root encounter yields
    // first-raster-pixel order
    int32_t next = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (ann[i] == 0) { out[i] = 0; continue; }
        int32_t r = find((int32_t)i);
        if (r == (int32_t)i) out[i] = ++next;
        else out[i] = out[r];
    }
    return next;
}

// Fused HV-target generation (gen_instance_hv_map semantics,
// hover_net_tpu/ops/targets.py — itself pinned bit-exactly against a
// transcription of reference models/hovernet/targets.py:17-96).
// Three O(area) passes: (1) fragment_labels union-find (the
// fix_mirror_padding partition — renumbering VALUES never escape
// target gen, only the partition matters), (2) per-fragment stats
// (count / sum_y / sum_x / bbox / pixel count inside the center-crop
// window), (3) render the normalized x/y offset maps. Rounding is kept
// bit-identical to the NumPy path: center-of-mass uses float64
// `floor(A/c + 0.5)`, offsets and denominators divide in float32.
//
// ann:   [h, w] int32 (original instance ids, 0 background)
// crop:  cy0/cy1/cx0/cx1 — the survivor-counting center-crop window
// out_x, out_y: [h, w] float32 (caller-allocated; overwritten)
// frag:  [h, w] int32 scratch (fragment map, reusable by the caller)
// Returns the fragment count F (>= 0; never fails).
int32_t hv_targets(const int32_t* ann, int64_t h, int64_t w,
                   int64_t cy0, int64_t cy1, int64_t cx0, int64_t cx1,
                   int64_t min_size, float* out_x, float* out_y,
                   int32_t* frag) {
    const int64_t n = h * w;
    int32_t nf = fragment_labels(ann, h, w, frag);
    std::memset(out_x, 0, sizeof(float) * (size_t)n);
    std::memset(out_y, 0, sizeof(float) * (size_t)n);
    if (nf == 0) return 0;

    std::vector<int64_t> cnt((size_t)nf + 1, 0), sum_y((size_t)nf + 1, 0),
        sum_x((size_t)nf + 1, 0), crop_cnt((size_t)nf + 1, 0);
    std::vector<int64_t> rmin((size_t)nf + 1, h), rmax((size_t)nf + 1, -1),
        cmin((size_t)nf + 1, w), cmax((size_t)nf + 1, -1);

    for (int64_t y = 0; y < h; ++y) {
        const int32_t* row = frag + y * w;
        const bool in_rows = (y >= cy0 && y < cy1);
        for (int64_t x = 0; x < w; ++x) {
            int32_t f = row[x];
            if (f == 0) continue;
            cnt[f] += 1;
            sum_y[f] += y;
            sum_x[f] += x;
            if (y < rmin[f]) rmin[f] = y;
            if (y > rmax[f]) rmax[f] = y;
            if (x < cmin[f]) cmin[f] = x;
            if (x > cmax[f]) cmax[f] = x;
            if (in_rows && x >= cx0 && x < cx1) crop_cnt[f] += 1;
        }
    }

    // per-fragment anchor / denominators / keep mask
    std::vector<float> anchor_y((size_t)nf + 1), anchor_x((size_t)nf + 1),
        dn_y((size_t)nf + 1), dp_y((size_t)nf + 1), dn_x((size_t)nf + 1),
        dp_x((size_t)nf + 1);
    std::vector<uint8_t> ok((size_t)nf + 1, 0);
    for (int32_t f = 1; f <= nf; ++f) {
        int64_t rmin_e = rmin[f] - 2 > 0 ? rmin[f] - 2 : 0;
        int64_t rmax_e = rmax[f] + 3 < h ? rmax[f] + 3 : h;
        int64_t cmin_e = cmin[f] - 2 > 0 ? cmin[f] - 2 : 0;
        int64_t cmax_e = cmax[f] + 3 < w ? cmax[f] + 3 : w;
        if (crop_cnt[f] < min_size || rmax_e - rmin_e < 2 ||
            cmax_e - cmin_e < 2)
            continue;
        ok[f] = 1;
        // float64 floor(A/c + 0.5), exactly like the NumPy path
        double icom_y = std::floor(
            (double)(sum_y[f] - cnt[f] * rmin_e) / (double)cnt[f] + 0.5);
        double icom_x = std::floor(
            (double)(sum_x[f] - cnt[f] * cmin_e) / (double)cnt[f] + 0.5);
        int64_t ay = rmin_e + (int64_t)icom_y - 1;
        int64_t ax = cmin_e + (int64_t)icom_x - 1;
        anchor_y[f] = (float)ay;
        anchor_x[f] = (float)ax;
        float neg_y = (float)(rmin[f] - ay), pos_y = (float)(rmax[f] - ay);
        float neg_x = (float)(cmin[f] - ax), pos_x = (float)(cmax[f] - ax);
        dn_y[f] = neg_y < 0.f ? -neg_y : 1.f;
        dp_y[f] = pos_y > 0.f ? pos_y : 1.f;
        dn_x[f] = neg_x < 0.f ? -neg_x : 1.f;
        dp_x[f] = pos_x > 0.f ? pos_x : 1.f;
    }

    for (int64_t y = 0; y < h; ++y) {
        const int32_t* row = frag + y * w;
        float* ox = out_x + y * w;
        float* oy = out_y + y * w;
        for (int64_t x = 0; x < w; ++x) {
            int32_t f = row[x];
            if (f == 0 || !ok[f]) continue;
            float yo = (float)y - anchor_y[f];
            float xo = (float)x - anchor_x[f];
            oy[x] = yo < 0.f ? yo / dn_y[f] : (yo > 0.f ? yo / dp_y[f] : 0.f);
            ox[x] = xo < 0.f ? xo / dn_x[f] : (xo > 0.f ? xo / dp_x[f] : 0.f);
        }
    }
    return nf;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// JSON emission for the standard instance-info payload.
//
// json.dump of a 50k-nuclei WSI dict costs ~5 s in CPython (ndarray ->
// tolist -> serializer); at the 100k x 80k north-star scale (1-2M
// nuclei) that alone would approach the whole <5 min budget. This
// emits the exact {"<id>": {bbox, centroid, contour, type_prob, type}}
// schema (infer/base.py save_json contract, reference infer/base.py:
// 80-94) from flat tables in one pass. Doubles print via
// std::to_chars shortest round-trip (same digits CPython repr picks);
// integral doubles get ".0" appended to keep json.loads returning
// float exactly like CPython's output would.

namespace {

inline char* emit_double(char* p, double v) {
    auto res = std::to_chars(p, p + 32, v);
    char* q = res.ptr;
    bool plain = true;
    for (char* c = p; c < q; ++c) {
        if (*c == '.' || *c == 'e' || *c == 'n' || *c == 'i') {
            plain = false;
            break;
        }
    }
    if (plain) { *q++ = '.'; *q++ = '0'; }
    return q;
}

inline char* emit_i64(char* p, int64_t v) {
    auto res = std::to_chars(p, p + 24, v);
    return res.ptr;
}

}  // namespace

extern "C" {

// ids [n] int64 (emitted as object keys, in order); bbox [n,4]
// (rmin, cmin, rmax, cmax); centroid [n,2] (x, y) float64;
// contour_offs [n+1] int64 into contour_pts [total,2] int32 (x, y);
// type_ids [n] int32 / type_probs [n] float64 or NULL for the untyped
// "type": null / "type_prob": null contract. mag_json: the
// already-serialized magnification value ("null", "40", ...).
// Writes the full payload into out (cap bytes); returns bytes written
// or -1 when the buffer is too small (caller retries larger).
int64_t emit_nuc_json(const int64_t* ids, int64_t n, const int64_t* bbox,
                      const double* centroid, const int64_t* contour_offs,
                      const int32_t* contour_pts, const int32_t* type_ids,
                      const double* type_probs, const char* mag_json,
                      char* out, int64_t cap) {
    char* p = out;
    char* end = out + cap;
    // worst-case bytes for one instance, excluding its contour points
    const int64_t fixed_worst = 256;

    auto room = [&](int64_t need) { return end - p >= need; };

    if (!room((int64_t)std::strlen(mag_json) + 32)) return -1;
    p += std::snprintf(p, (size_t)(end - p), "{\"mag\": %s, \"nuc\": {",
                       mag_json);
    for (int64_t i = 0; i < n; ++i) {
        int64_t npts = contour_offs[i + 1] - contour_offs[i];
        if (!room(fixed_worst + npts * 16)) return -1;
        if (i) { *p++ = ','; *p++ = ' '; }
        *p++ = '"';
        p = emit_i64(p, ids[i]);
        *p++ = '"'; *p++ = ':'; *p++ = ' ';
        std::memcpy(p, "{\"bbox\": [[", 11); p += 11;
        p = emit_i64(p, bbox[i * 4 + 0]); *p++ = ','; *p++ = ' ';
        p = emit_i64(p, bbox[i * 4 + 1]);
        std::memcpy(p, "], [", 4); p += 4;
        p = emit_i64(p, bbox[i * 4 + 2]); *p++ = ','; *p++ = ' ';
        p = emit_i64(p, bbox[i * 4 + 3]);
        std::memcpy(p, "]], \"centroid\": [", 17); p += 17;
        p = emit_double(p, centroid[i * 2 + 0]); *p++ = ','; *p++ = ' ';
        p = emit_double(p, centroid[i * 2 + 1]);
        std::memcpy(p, "], \"contour\": [", 15); p += 15;
        const int32_t* pts = contour_pts + contour_offs[i] * 2;
        for (int64_t k = 0; k < npts; ++k) {
            if (k) { *p++ = ','; *p++ = ' '; }
            *p++ = '[';
            p = emit_i64(p, pts[k * 2 + 0]); *p++ = ','; *p++ = ' ';
            p = emit_i64(p, pts[k * 2 + 1]);
            *p++ = ']';
        }
        std::memcpy(p, "], \"type_prob\": ", 16); p += 16;
        if (type_probs) p = emit_double(p, type_probs[i]);
        else { std::memcpy(p, "null", 4); p += 4; }
        std::memcpy(p, ", \"type\": ", 10); p += 10;
        if (type_ids) p = emit_i64(p, (int64_t)type_ids[i]);
        else { std::memcpy(p, "null", 4); p += 4; }
        *p++ = '}';
    }
    if (!room(4)) return -1;
    *p++ = '}'; *p++ = '}';
    return p - out;
}

}  // extern "C"
