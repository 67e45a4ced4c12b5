"""Typed launch errors of the CUDA kernels, and the count of in-place writes.

Each kernel library exports plain C launch functions that return a CUDA
error code (``csrc/``).  :func:`raise_on_error` turns a non-zero code into
a :class:`CudaLaunchError` that carries it, so that the recovery layer
(``repro_torch.resilience.degrade``) classifies a failure by its code,
never by its message:

* ``cudaErrorMemoryAllocation`` (2) and ``cudaErrorLaunchOutOfResources``
  (701), and :class:`SharedMemoryOverflow`: a k-sweep or shard tile the
  card cannot hold -- demoted to the per-half-sweep tier;
* the sticky codes (:data:`STICKY_CODES`: an illegal or misaligned
  address, a kernel that faulted) poison the CUDA context, and no retry
  can succeed -- they propagate at once;
* everything else propagates too.

A k-sweep or shard tile's shared memory is checked against the card's
opt-in maximum (``cudaDevAttrMaxSharedMemoryPerBlockOptin``) before the
launch (:func:`check_shared_memory`): ``cudaFuncSetAttribute`` reports an
overflow as ``cudaErrorInvalidValue`` (1), a code that also means other
faults, so the launchers report it as :class:`SharedMemoryOverflow`.

The per-half-sweep kernels (and their plain versions) update their target
planes in place; each such write calls :func:`note_in_place` once it has
happened, so that the recovery layer can tell whether a failed dispatch
already moved its state (:func:`in_place_count`).
"""
from __future__ import annotations

import ctypes

#: cudaErrorInvalidValue: what cudaFuncSetAttribute returns for too much
#: dynamic shared memory, among other faults
INVALID_VALUE = 1
#: cudaErrorMemoryAllocation
MEMORY_ALLOCATION = 2
#: cudaErrorLaunchOutOfResources
LAUNCH_OUT_OF_RESOURCES = 701
#: codes that leave the CUDA context unusable: illegal address (700),
#: hardware stack error (714), illegal instruction (715), misaligned
#: address (716), invalid address space (717), invalid program counter
#: (718), launch failure (719)
STICKY_CODES = frozenset({700, 714, 715, 716, 717, 718, 719})
#: codes of a launch the card could not hold: demotable
RESOURCE_CODES = frozenset({MEMORY_ALLOCATION, LAUNCH_OUT_OF_RESOURCES})


class CudaLaunchError(RuntimeError):
    """A kernel launch returned the CUDA error ``code``."""

    def __init__(self, what: str, code: int, message: str):
        self.what = what
        self.code = int(code)
        super().__init__(f"{what} launch failed: CUDA error {code} "
                         f"({message})")

    @property
    def sticky(self) -> bool:
        """Whether the code poisons the CUDA context."""
        return self.code in STICKY_CODES


class SharedMemoryOverflow(CudaLaunchError):
    """A tile needs more dynamic shared memory than one block of the card
    may opt in to: reported before the launch, with the code
    ``cudaFuncSetAttribute`` would have returned."""

    def __init__(self, what: str, need: int, limit: int):
        self.need = int(need)
        self.limit = int(limit)
        super().__init__(what, INVALID_VALUE,
                         f"its tile needs {need} B of shared memory, over "
                         f"the card's opt-in maximum of {limit} B a block")


def raise_on_error(lib, rc: int, what: str) -> None:
    """Raise :class:`CudaLaunchError` for a non-zero return code ``rc`` of
    ``lib``'s launch function for ``what``."""
    if rc != 0:
        raise CudaLaunchError(what, rc, lib.cuda_error_string(rc).decode())


#: the opt-in maximum of shared memory a block, by device index
_OPTIN_BYTES: dict = {}


def max_shared_memory(lib, device) -> int:
    """Bytes of dynamic shared memory one block may opt in to on the CUDA
    ``device`` (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, read through
    ``lib``'s ``device_smem_optin`` once per device)."""
    index = device.index
    if index is None:
        import torch
        index = torch.cuda.current_device()
    if index not in _OPTIN_BYTES:
        fn = lib.device_smem_optin
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_int
        out = ctypes.c_int(0)
        raise_on_error(lib, fn(index, ctypes.byref(out)),
                       "cudaDeviceGetAttribute")
        _OPTIN_BYTES[index] = out.value
    return _OPTIN_BYTES[index]


def check_shared_memory(lib, what: str, device, query: str, *args) -> None:
    """Raise :class:`SharedMemoryOverflow` where the shared memory a block
    that ``lib``'s function ``query`` gives for ``args`` (a tile and its
    sweeps) is over the opt-in maximum of the CUDA ``device``; planes on
    another device have no such limit."""
    if device.type != "cuda":
        return
    need = getattr(lib, query)(*args)
    limit = max_shared_memory(lib, device)
    if need > limit:
        raise SharedMemoryOverflow(what, need, limit)


_IN_PLACE = [0]


def note_in_place() -> None:
    """One more write of state planes in place (a launch of a
    per-half-sweep kernel, or its plain version's update)."""
    _IN_PLACE[0] += 1


def in_place_count() -> int:
    """Writes of state planes in place since the process started."""
    return _IN_PLACE[0]
