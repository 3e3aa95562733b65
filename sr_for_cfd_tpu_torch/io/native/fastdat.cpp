// Fast .dat field writer (the port's copy of
// `sr_for_cfd_tpu/io/native/fastdat.cpp`, built by its own loader).
//
// The reference's full-field dump (`LDV PyCFD given by sir.py:245-258`)
// formats (nvar, nx+2, ny+2) float64 values as "%.6f \t" rows. Python's
// string formatting takes ~0.5 s for a 400x400 field; this writer appends
// the same section bodies from C and is loaded with ctypes
// (`io/native_io.py`). `io/datfiles.py` writes the small header itself and
// rewrites the whole file in Python when this writer is unavailable.
//
// Build: g++ -O2 -shared -fPIC -o _fastdat.so fastdat.cpp
// (done at first use by sr_for_cfd_tpu_torch/io/native_io.py, into
// sr_for_cfd_tpu_torch/_build/)

#include <cstdio>

extern "C" {

// Appends the per-variable sections ("# ########## U velocity ############"
// + formatted rows) to an existing file. Returns 0 on success.
int append_field_sections(const char* filename, const double* var, long nvar,
                          long nxp, long nyp) {
    FILE* f = std::fopen(filename, "a");
    if (!f) return 1;
    static const char* names[3] = {"U", "V", "P"};
    char buf[64];
    for (long k = 0; k < nvar; ++k) {
        const char* name = (k < 3) ? names[k] : "?";
        std::fprintf(f, "\n# ########## %s velocity ############ \n", name);
        for (long i = 0; i < nxp; ++i) {
            const double* row = var + (k * nxp + i) * nyp;
            for (long j = 0; j < nyp; ++j) {
                int n = std::snprintf(buf, sizeof buf, "%.6f \t", row[j]);
                std::fwrite(buf, 1, (size_t)n, f);
            }
            std::fputc('\n', f);
        }
    }
    int rc = std::ferror(f);
    // fclose flushes the last stdio buffer; a failed flush (e.g. ENOSPC)
    // must fail the call, or a truncated file would look complete
    if (std::fclose(f) != 0) rc = 1;
    return rc;
}

}  // extern "C"
