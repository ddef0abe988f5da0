// t-digest: streaming quantile sketch (the reference leans on the crick
// Cython TDigest for latency digests, counter.py:7; this is the
// native-equivalent, SURVEY §2 native obligations (c)).
//
// Merging variant (Dunning & Ertl): points buffer into `unmerged`; when
// full they are sorted and merged into the centroid list under the scale
// -function size bound k1(q) = delta/(2*pi) * asin(2q-1).
//
// C ABI for ctypes: tdigest_new/free/add/merge/quantile/count/
// serialize/deserialize.  No Python.h dependency: the extension loads
// via ctypes so it works without build-time CPython headers.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Centroid {
    double mean;
    double weight;
    bool operator<(const Centroid& o) const { return mean < o.mean; }
};

struct TDigest {
    double compression;
    std::vector<Centroid> centroids;
    std::vector<Centroid> unmerged;
    double total_weight = 0.0;   // merged weight
    double unmerged_weight = 0.0;
    double min = INFINITY;
    double max = -INFINITY;

    explicit TDigest(double comp) : compression(comp) {
        centroids.reserve(static_cast<size_t>(2 * comp) + 8);
        unmerged.reserve(static_cast<size_t>(comp));
    }

    static double k1(double q, double comp) {
        q = std::min(1.0, std::max(0.0, q));
        return comp / (2.0 * M_PI) * std::asin(2.0 * q - 1.0);
    }

    void flush() {
        if (unmerged.empty()) return;
        std::sort(unmerged.begin(), unmerged.end());
        std::vector<Centroid> merged;
        merged.reserve(centroids.size() + unmerged.size());
        // merge-sort the two sorted runs
        std::vector<Centroid> all;
        all.reserve(centroids.size() + unmerged.size());
        std::merge(centroids.begin(), centroids.end(), unmerged.begin(),
                   unmerged.end(), std::back_inserter(all));
        unmerged.clear();
        double total = total_weight + unmerged_weight;
        total_weight = total;
        unmerged_weight = 0.0;
        if (all.empty()) return;

        double so_far = 0.0;
        Centroid cur = all[0];
        double k_lower = k1(0.0, compression);
        for (size_t i = 1; i < all.size(); i++) {
            double proposed = cur.weight + all[i].weight;
            double q_upper = (so_far + proposed) / total;
            if (k1(q_upper, compression) - k_lower <= 1.0) {
                // merge into the current centroid
                cur.mean += (all[i].mean - cur.mean) * all[i].weight / proposed;
                cur.weight = proposed;
            } else {
                so_far += cur.weight;
                k_lower = k1(so_far / total, compression);
                merged.push_back(cur);
                cur = all[i];
            }
        }
        merged.push_back(cur);
        centroids = std::move(merged);
    }

    void add(double x, double w) {
        if (std::isnan(x) || w <= 0) return;
        unmerged.push_back({x, w});
        unmerged_weight += w;
        min = std::min(min, x);
        max = std::max(max, x);
        if (unmerged.size() >= static_cast<size_t>(compression)) flush();
    }

    double quantile(double q) {
        flush();
        if (centroids.empty()) return NAN;
        if (centroids.size() == 1) return centroids[0].mean;
        q = std::min(1.0, std::max(0.0, q));
        double target = q * total_weight;
        double so_far = 0.0;
        for (size_t i = 0; i < centroids.size(); i++) {
            double mid = so_far + centroids[i].weight / 2.0;
            if (target < mid || i + 1 == centroids.size()) {
                // interpolate between neighbouring centroid means
                if (i == 0 && target < centroids[0].weight / 2.0) {
                    double lo = min, hi = centroids[0].mean;
                    double t = target / (centroids[0].weight / 2.0);
                    return lo + t * (hi - lo);
                }
                double prev_mid = so_far - centroids[i - 1].weight / 2.0;
                double t = (target - prev_mid) / (mid - prev_mid);
                return centroids[i - 1].mean +
                       t * (centroids[i].mean - centroids[i - 1].mean);
            }
            so_far += centroids[i].weight;
        }
        return centroids.back().mean;
    }
};

}  // namespace

extern "C" {

void* tdigest_new(double compression) { return new TDigest(compression); }

void tdigest_free(void* d) { delete static_cast<TDigest*>(d); }

void tdigest_add(void* d, double x, double w) {
    static_cast<TDigest*>(d)->add(x, w);
}

void tdigest_add_batch(void* d, const double* xs, int64_t n) {
    auto* t = static_cast<TDigest*>(d);
    for (int64_t i = 0; i < n; i++) t->add(xs[i], 1.0);
}

double tdigest_quantile(void* d, double q) {
    return static_cast<TDigest*>(d)->quantile(q);
}

double tdigest_count(void* d) {
    auto* t = static_cast<TDigest*>(d);
    return t->total_weight + t->unmerged_weight;
}

double tdigest_min(void* d) { return static_cast<TDigest*>(d)->min; }
double tdigest_max(void* d) { return static_cast<TDigest*>(d)->max; }

// serialize: [n, (mean, weight) * n] doubles into caller buffer;
// returns required length (call with null to size)
int64_t tdigest_serialize(void* d, double* out, int64_t cap) {
    auto* t = static_cast<TDigest*>(d);
    t->flush();
    int64_t need = 1 + 2 * static_cast<int64_t>(t->centroids.size());
    if (out == nullptr || cap < need) return need;
    out[0] = static_cast<double>(t->centroids.size());
    for (size_t i = 0; i < t->centroids.size(); i++) {
        out[1 + 2 * i] = t->centroids[i].mean;
        out[2 + 2 * i] = t->centroids[i].weight;
    }
    return need;
}

void tdigest_merge_serialized(void* d, const double* data, int64_t len) {
    auto* t = static_cast<TDigest*>(d);
    if (len < 1) return;
    int64_t n = static_cast<int64_t>(data[0]);
    for (int64_t i = 0; i < n && 1 + 2 * i + 1 < len; i++) {
        t->add(data[1 + 2 * i], data[2 + 2 * i]);
    }
}

}  // extern "C"
