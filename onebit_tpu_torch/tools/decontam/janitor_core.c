/* Fast n-gram scanner for train/test decontamination.
 *
 * Native core of onebit_tpu_torch/tools/decontam/janitor.py: the
 * counterpart of the reference's *expected but not shipped* pybind11
 * module (evaluation/lm_eval/decontamination/janitor.py:8-16 documents the
 * missing janitor_util.cpp).  Built with the plain CPython C API (no
 * pybind11) by janitor.py at first use, into build/decontam/ at the root
 * of the checkout.  A copy of onebit_tpu/tools/decontam/janitor_core.c.
 *
 * API:
 *   clean_ngram(text, delete_chars, n) -> list[str]
 *       normalized (lowercased, delete_chars removed) space-joined word
 *       n-grams.
 *   clean_ngram_with_indices(text, delete_chars, n)
 *       -> list[(ngram, start, end)] with [start, end] byte indices of the
 *       n-gram span in the ORIGINAL string (end inclusive, matching the
 *       python fallback's split_indices convention).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <ctype.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    char *norm;        /* normalized word (heap) */
    Py_ssize_t start;  /* raw start index */
    Py_ssize_t end;    /* raw end index (inclusive) */
} Word;

/* Tokenize `text`, lowercasing and dropping chars in `del_set`.
 * Returns number of words; fills *out (caller frees each norm + array). */
static Py_ssize_t tokenize(const char *text, Py_ssize_t len,
                           const char del_set[256], Word **out) {
    Py_ssize_t cap = 64, n = 0;
    Word *words = malloc(cap * sizeof(Word));
    if (!words) return -1;

    Py_ssize_t i = 0;
    while (i < len) {
        while (i < len && isspace((unsigned char)text[i])) i++;
        if (i >= len) break;
        Py_ssize_t start = i;
        while (i < len && !isspace((unsigned char)text[i])) i++;
        Py_ssize_t end = i - 1;

        /* normalize the raw word */
        Py_ssize_t wlen = i - start;
        char *norm = malloc(wlen + 1);
        if (!norm) goto fail;
        Py_ssize_t k = 0;
        for (Py_ssize_t j = start; j < i; j++) {
            unsigned char c = (unsigned char)text[j];
            if (del_set[c]) continue;
            norm[k++] = (char)tolower(c);
        }
        norm[k] = '\0';

        if (n == cap) {
            cap *= 2;
            Word *nw = realloc(words, cap * sizeof(Word));
            if (!nw) { free(norm); goto fail; }
            words = nw;
        }
        words[n].norm = norm;
        words[n].start = start;
        words[n].end = end;
        n++;
    }
    *out = words;
    return n;
fail:
    for (Py_ssize_t j = 0; j < n; j++) free(words[j].norm);
    free(words);
    return -1;
}

static void free_words(Word *words, Py_ssize_t n) {
    for (Py_ssize_t i = 0; i < n; i++) free(words[i].norm);
    free(words);
}

/* Join words[i..i+n) with single spaces into a fresh PyUnicode. */
static PyObject *join_ngram(Word *words, Py_ssize_t i, Py_ssize_t n) {
    Py_ssize_t total = 0;
    for (Py_ssize_t j = 0; j < n; j++) total += strlen(words[i + j].norm) + 1;
    char *buf = malloc(total + 1);
    if (!buf) return PyErr_NoMemory();
    char *p = buf;
    for (Py_ssize_t j = 0; j < n; j++) {
        size_t l = strlen(words[i + j].norm);
        memcpy(p, words[i + j].norm, l);
        p += l;
        if (j + 1 < n) *p++ = ' ';
    }
    *p = '\0';
    PyObject *s = PyUnicode_FromString(buf);
    free(buf);
    return s;
}

static int parse_args(PyObject *args, const char **text, Py_ssize_t *len,
                      char del_set[256], Py_ssize_t *n) {
    const char *dels;
    Py_ssize_t dlen;
    if (!PyArg_ParseTuple(args, "s#s#n", text, len, &dels, &dlen, n))
        return 0;
    if (*n <= 0) {
        PyErr_SetString(PyExc_ValueError, "n must be positive");
        return 0;
    }
    memset(del_set, 0, 256);
    for (Py_ssize_t i = 0; i < dlen; i++)
        del_set[(unsigned char)dels[i]] = 1;
    return 1;
}

static PyObject *clean_ngram(PyObject *self, PyObject *args) {
    const char *text;
    Py_ssize_t len, n;
    char del_set[256];
    if (!parse_args(args, &text, &len, del_set, &n)) return NULL;

    Word *words;
    Py_ssize_t nw = tokenize(text, len, del_set, &words);
    if (nw < 0) return PyErr_NoMemory();

    PyObject *list = PyList_New(nw >= n ? nw - n + 1 : 0);
    if (!list) { free_words(words, nw); return NULL; }
    for (Py_ssize_t i = 0; i + n <= nw; i++) {
        PyObject *s = join_ngram(words, i, n);
        if (!s) { Py_DECREF(list); free_words(words, nw); return NULL; }
        PyList_SET_ITEM(list, i, s);
    }
    free_words(words, nw);
    return list;
}

static PyObject *clean_ngram_with_indices(PyObject *self, PyObject *args) {
    const char *text;
    Py_ssize_t len, n;
    char del_set[256];
    if (!parse_args(args, &text, &len, del_set, &n)) return NULL;

    Word *words;
    Py_ssize_t nw = tokenize(text, len, del_set, &words);
    if (nw < 0) return PyErr_NoMemory();

    PyObject *list = PyList_New(nw >= n ? nw - n + 1 : 0);
    if (!list) { free_words(words, nw); return NULL; }
    for (Py_ssize_t i = 0; i + n <= nw; i++) {
        PyObject *s = join_ngram(words, i, n);
        if (!s) { Py_DECREF(list); free_words(words, nw); return NULL; }
        PyObject *tup = Py_BuildValue("(Nnn)", s, words[i].start,
                                      words[i + n - 1].end);
        if (!tup) { Py_DECREF(list); free_words(words, nw); return NULL; }
        PyList_SET_ITEM(list, i, tup);
    }
    free_words(words, nw);
    return list;
}

static PyMethodDef Methods[] = {
    {"clean_ngram", clean_ngram, METH_VARARGS,
     "clean_ngram(text, delete_chars, n) -> list of normalized ngrams"},
    {"clean_ngram_with_indices", clean_ngram_with_indices, METH_VARARGS,
     "clean_ngram_with_indices(text, delete_chars, n) -> "
     "list of (ngram, start, end)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef module = {
    PyModuleDef_HEAD_INIT, "_janitor_core", NULL, -1, Methods};

PyMODINIT_FUNC PyInit__janitor_core(void) {
    return PyModule_Create(&module);
}
