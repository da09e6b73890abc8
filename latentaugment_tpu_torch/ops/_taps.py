"""Host-side filter taps for the CUDA kernels' specialised variants.

The variants take their taps as kernel parameters (constant memory), so
the wrapper needs them on the host. `host_taps` copies a filter tensor
once and remembers it; `correlation_taps` and `polyphase_table` are plain
Python on the copied values and run anywhere.
"""

import collections
import ctypes
import functools
import threading

_HOST_TAPS = collections.OrderedDict()
_HOST_TAPS_MAX = 256
_HOST_TAPS_LOCK = threading.Lock()  # a served program runs in several threads


def host_taps(f):
    """The values of a 1-D filter tensor as a tuple of floats. The copy
    from the device synchronises, so it is made once per tensor: the
    result is kept under the tensor's storage address and version, with
    the tensor itself, so that the address cannot be given to another
    filter while the entry lives. An in-place edit bumps the version and
    is copied anew."""
    key = (f.device, f.data_ptr(), f._version, tuple(f.shape), f.dtype)
    with _HOST_TAPS_LOCK:
        hit = _HOST_TAPS.get(key)
        if hit is not None:
            _HOST_TAPS.move_to_end(key)
            return hit[1]
    taps = tuple(float(v) for v in f.detach().to('cpu', copy=True).double().tolist())
    with _HOST_TAPS_LOCK:
        _HOST_TAPS[key] = (f, taps)
        if len(_HOST_TAPS) > _HOST_TAPS_MAX:
            _HOST_TAPS.popitem(last=False)
    return taps


def correlation_taps(taps, flip, gain=1.0):
    """The taps a kernel correlates with: the op convolves unless `flip`,
    so they are reversed then; `gain` scales them."""
    taps = taps if flip else taps[::-1]
    return tuple(t * gain for t in taps)


def polyphase_table(taps, up, pad):
    """Tap table of a FIR over a zero-inserted signal, by output phase.

    Output m of `sum_a taps[a] * Z[m + a - pad]`, with Z the input with
    up - 1 zeros after every sample, meets inputs only at the taps
    a = phi, phi + up, ... With m = up * g + e (e in [0, up), g any
    integer), the table's row e holds the live taps placed so that entry
    k multiplies input g + j0 + k: len(taps) / up + 1 entries, the first
    or the last of them 0. Returns (rows, j0)."""
    n, rem = divmod(len(taps), up)
    if rem:
        raise ValueError(f"{len(taps)} taps do not split into {up} phases")
    first = [-((pad - e) // up) for e in range(up)]  # ceil((e - pad) / up)
    j0 = min(first)
    rows = []
    for e in range(up):
        phi = up * first[e] - (e - pad)
        row = [0.0] * (n + 1)
        for k in range(n):
            row[k + first[e] - j0] = taps[phi + k * up]
        rows.append(tuple(row))
    return tuple(rows), j0


@functools.lru_cache(maxsize=1024)
def c_floats(values, size):
    """A ctypes float array of `size` entries holding `values`, 0 after."""
    return (ctypes.c_float * size)(*values)
