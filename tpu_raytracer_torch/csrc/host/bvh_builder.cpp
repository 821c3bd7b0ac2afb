// Binned-SAH BVH builder emitting the unified DFS stream (see ops/bvh.py).
//
// A verbatim copy of tpu_raytracer/runtime/native/bvh_builder.cpp, built
// with the same g++ flags: the DFS leaf order it produces sets the
// triangle chunk layout and every triangle id, so the PyTorch port must
// reproduce the JAX package's tree exactly. The port has no Python
// fallback builder for that reason.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct V3 {
    float x, y, z;
};

inline V3 vmin(const V3& a, const V3& b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3& a, const V3& b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float area(const V3& mn, const V3& mx) {
    float dx = std::max(mx.x - mn.x, 0.f);
    float dy = std::max(mx.y - mn.y, 0.f);
    float dz = std::max(mx.z - mn.z, 0.f);
    return dx * dy + dy * dz + dz * dx;
}

struct Builder {
    const V3* mn;
    const V3* mx;
    std::vector<V3> cent;
    int leaf_size;
    int num_bins;
    int max_records;

    float* rec;
    int32_t* skip;
    int32_t* tri_id;
    int32_t* left;
    int32_t* right;
    int32_t* depth;
    int count = 0;
    int max_depth = 0;
    bool overflow = false;

    int emit() {
        if (count >= max_records) {
            overflow = true;
            return max_records - 1;
        }
        int i = count++;
        std::memset(rec + i * 12, 0, 12 * sizeof(float));
        skip[i] = 0;
        tri_id[i] = -1;
        left[i] = -1;
        right[i] = -1;
        depth[i] = -1;
        return i;
    }

    int build(std::vector<int32_t>& idx, int lo, int hi, int d) {
        max_depth = std::max(max_depth, d);
        V3 node_mn = {kInf, kInf, kInf};
        V3 node_mx = {-kInf, -kInf, -kInf};
        for (int k = lo; k < hi; ++k) {
            node_mn = vmin(node_mn, mn[idx[k]]);
            node_mx = vmax(node_mx, mx[idx[k]]);
        }
        int my = emit();
        rec[my * 12 + 0] = node_mn.x;
        rec[my * 12 + 1] = node_mn.y;
        rec[my * 12 + 2] = node_mn.z;
        rec[my * 12 + 3] = node_mx.x;
        rec[my * 12 + 4] = node_mx.y;
        rec[my * 12 + 5] = node_mx.z;
        depth[my] = d;

        int n = hi - lo;
        if (n <= leaf_size) {
            for (int k = lo; k < hi; ++k) {
                int ti = emit();
                skip[ti] = -1;
                tri_id[ti] = idx[k];
            }
            skip[my] = count;
            return my;
        }

        // binned SAH over the widest centroid axis, median fallback
        V3 cmin = {kInf, kInf, kInf}, cmax = {-kInf, -kInf, -kInf};
        for (int k = lo; k < hi; ++k) {
            cmin = vmin(cmin, cent[idx[k]]);
            cmax = vmax(cmax, cent[idx[k]]);
        }
        float ext[3] = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
        int axis = ext[1] > ext[0] ? 1 : 0;
        if (ext[2] > ext[axis]) axis = 2;

        auto caxis = [&](int t) {
            const V3& c = cent[t];
            return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
        };

        int mid = -1;
        if (ext[axis] > 1e-12f) {
            float c0 = axis == 0 ? cmin.x : (axis == 1 ? cmin.y : cmin.z);
            float scale = num_bins * (1.0f - 1e-6f) / ext[axis];
            std::vector<int> bin_count(num_bins, 0);
            std::vector<V3> bmn(num_bins, {kInf, kInf, kInf});
            std::vector<V3> bmx(num_bins, {-kInf, -kInf, -kInf});
            for (int k = lo; k < hi; ++k) {
                int b = std::min(int((caxis(idx[k]) - c0) * scale),
                                 num_bins - 1);
                bin_count[b]++;
                bmn[b] = vmin(bmn[b], mn[idx[k]]);
                bmx[b] = vmax(bmx[b], mx[idx[k]]);
            }
            // sweep for best split
            std::vector<float> rarea(num_bins);
            {
                V3 amn = {kInf, kInf, kInf}, amx = {-kInf, -kInf, -kInf};
                for (int b = num_bins - 1; b >= 0; --b) {
                    amn = vmin(amn, bmn[b]);
                    amx = vmax(amx, bmx[b]);
                    rarea[b] = area(amn, amx);
                }
            }
            float best_cost = kInf;
            int best_split = -1;
            V3 amn = {kInf, kInf, kInf}, amx = {-kInf, -kInf, -kInf};
            int lcnt = 0;
            for (int s = 0; s < num_bins - 1; ++s) {
                amn = vmin(amn, bmn[s]);
                amx = vmax(amx, bmx[s]);
                lcnt += bin_count[s];
                int rcnt = n - lcnt;
                if (lcnt == 0 || rcnt == 0) continue;
                float cost = area(amn, amx) * lcnt + rarea[s + 1] * rcnt;
                if (cost < best_cost) {
                    best_cost = cost;
                    best_split = s;
                }
            }
            if (best_split >= 0) {
                float split_val = best_split;
                auto it = std::partition(
                    idx.begin() + lo, idx.begin() + hi, [&](int t) {
                        int b = std::min(int((caxis(t) - c0) * scale),
                                         num_bins - 1);
                        return b <= split_val;
                    });
                mid = int(it - idx.begin());
                if (mid == lo || mid == hi) mid = -1;
            }
        }
        if (mid < 0) {
            mid = lo + n / 2;
            std::nth_element(idx.begin() + lo, idx.begin() + mid,
                             idx.begin() + hi, [&](int a, int b) {
                                 return caxis(a) < caxis(b);
                             });
        }

        int li = build(idx, lo, mid, d + 1);
        int ri = build(idx, mid, hi, d + 1);
        left[my] = li;
        right[my] = ri;
        skip[my] = count;
        return my;
    }
};

}  // namespace

extern "C" {

// Returns stream length S, or -1 on overflow (max_records too small).
int tpurt_build_bvh(const float* aabb_min, const float* aabb_max,
                    int t_count, int leaf_size, int num_bins,
                    float* rec, int32_t* skip, int32_t* tri_id,
                    int32_t* left, int32_t* right, int32_t* depth,
                    int32_t* out_max_depth, int max_records) {
    Builder b;
    b.mn = reinterpret_cast<const V3*>(aabb_min);
    b.mx = reinterpret_cast<const V3*>(aabb_max);
    b.cent.resize(t_count);
    for (int i = 0; i < t_count; ++i) {
        b.cent[i] = {(b.mn[i].x + b.mx[i].x) * 0.5f,
                     (b.mn[i].y + b.mx[i].y) * 0.5f,
                     (b.mn[i].z + b.mx[i].z) * 0.5f};
    }
    b.leaf_size = leaf_size;
    b.num_bins = num_bins;
    b.max_records = max_records;
    b.rec = rec;
    b.skip = skip;
    b.tri_id = tri_id;
    b.left = left;
    b.right = right;
    b.depth = depth;

    if (t_count > 0) {
        std::vector<int32_t> idx(t_count);
        for (int i = 0; i < t_count; ++i) idx[i] = i;
        b.build(idx, 0, t_count, 0);
    }
    if (b.overflow) return -1;
    *out_max_depth = b.max_depth;
    return b.count;
}

}  // extern "C"
