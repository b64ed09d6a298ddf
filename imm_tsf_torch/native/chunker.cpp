// Sliding-window chunker — native core for the dataset-build hot loop
// (a copy of imm_tsf_tpu/native/chunker.cpp).
//
// The reference's chunk loop (lib/parse_datasets.py:174-237) re-scans the
// full timestamp array per window (O(W*T) boolean masks in Python). This
// C++ core runs the same scan with two pointers + prefix sums in O(T + W),
// emitting per-window [start_idx, end_idx) plus the validity flags the
// reference enforces:
//   >=2 points in the window            (:186)
//   >=1 observed value in history part  (:196-201)
//   >=1 observed value in pred part
//   >=1 text note in [st, st+history)   (:217-221, drop rule)
//
// Built with g++ -O3 -shared -fPIC by kernels/_build.py; bound via ctypes
// (native/__init__.py); the dataset's NumPy loop remains for records
// whose notes are unsorted, and as the tests' oracle.

#include <cstdint>
#include <cstddef>

extern "C" {

// tt:        [n] sorted chunk times (float64)
// mask_rowsum: [n] per-point sum of the observation mask (float64)
// note_t:    [m] sorted note times (float64)
// history, pred_window, stride: window params
// starts_out/ends_out: [max_windows] index ranges (int64)
// hist_ends_out: [max_windows] index of first point with t >= st+history
// valid_out: [max_windows] 1 = emit chunk, 0 = skip (fails obs checks)
// text_out:  [max_windows] 1 = has >=1 note in history window
// note_lo_out/note_hi_out: [max_windows] note index ranges in hist window
// returns: number of windows scanned (<= max_windows)
int64_t chunk_windows(
    const double* tt, const double* mask_rowsum, int64_t n,
    const double* note_t, int64_t m,
    double history, double pred_window, double stride,
    int64_t max_windows,
    int64_t* starts_out, int64_t* ends_out, int64_t* hist_ends_out,
    uint8_t* valid_out, uint8_t* text_out,
    int64_t* note_lo_out, int64_t* note_hi_out)
{
    if (n == 0) return 0;
    const double total = history + pred_window;
    const double t_min = tt[0];
    const double t_max = tt[n - 1];

    // prefix sums of mask_rowsum for O(1) observed-count queries
    // (heap buffer; n is per-entity, small)
    double* pref = new double[n + 1];
    pref[0] = 0.0;
    for (int64_t i = 0; i < n; ++i) pref[i + 1] = pref[i] + mask_rowsum[i];

    int64_t w = 0;
    int64_t lo = 0, hi = 0, he = 0;   // two pointers over tt
    int64_t nlo = 0, nhi = 0;         // two pointers over note_t
    double st = t_min;
    while (st + total <= t_max && w < max_windows) {
        while (lo < n && tt[lo] < st) ++lo;
        if (hi < lo) hi = lo;
        while (hi < n && tt[hi] < st + total) ++hi;
        if (he < lo) he = lo;
        while (he < n && tt[he] < st + history) ++he;
        if (he > hi) he = hi;

        while (nlo < m && note_t[nlo] < st) ++nlo;
        if (nhi < nlo) nhi = nlo;
        while (nhi < m && note_t[nhi] < st + history) ++nhi;

        starts_out[w] = lo;
        ends_out[w] = hi;
        hist_ends_out[w] = he;
        const double hist_obs = pref[he] - pref[lo];
        const double pred_obs = pref[hi] - pref[he];
        valid_out[w] = (hi - lo >= 2) && (hist_obs > 0.0) && (pred_obs > 0.0);
        text_out[w] = (nhi > nlo);
        note_lo_out[w] = nlo;
        note_hi_out[w] = nhi;
        ++w;
        st += stride;
        // pointers only move forward; rewind lo for overlapping windows
        // (stride may be < history so windows overlap): simplest correct
        // approach is to re-derive lo from scratch only when needed —
        // since st increases monotonically, lo/he/hi/nlo/nhi remain valid
        // lower bounds and the while-loops above advance them correctly.
    }
    delete[] pref;
    return w;
}

}  // extern "C"
