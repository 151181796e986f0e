"""NVML through `ctypes`: the device layer's readings of a real NVIDIA card.

``libnvidia-ml.so.1`` ships with the GPU driver, so no package is needed. Every
call's return code is checked: a failure raises `NvmlError`, which the
device sampler counts as a failed sample. The library object is a
parameter (`Nvml(lib=...)`), so tests pass a fake one that fills the
``byref`` arguments as NVML would.

This module imports the standard library only: the device sampler's helper
process (`device_sampler.py`) runs it without torch.
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

LIBRARY = "libnvidia-ml.so.1"

NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_FUNCTION_NOT_FOUND = 13
NVML_TEMPERATURE_GPU = 0
_UUID_LEN = 96  # NVML_DEVICE_UUID_V2_BUFFER_SIZE
_MAX_PROCS = 256


class NvmlError(RuntimeError):
    """An NVML call returned ``code`` (an ``nvmlReturn_t``)."""

    def __init__(self, fn: str, code: int, text: str = ""):
        super().__init__(f"{fn} returned {code}" + (f" ({text})" if text
                                                     else ""))
        self.fn, self.code = fn, code


class Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Memory(ctypes.Structure):
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class ProcessInfo(ctypes.Structure):
    """``nvmlProcessInfo_t`` as ``_v3`` fills it."""
    _fields_ = [("pid", ctypes.c_uint), ("usedGpuMemory", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


_dev = ctypes.c_void_p
_uint_p = ctypes.POINTER(ctypes.c_uint)
_PROTOTYPES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetHandleByUUID": [ctypes.c_char_p, ctypes.POINTER(_dev)],
    "nvmlDeviceGetUUID": [_dev, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetUtilizationRates": [_dev, ctypes.POINTER(Utilization)],
    "nvmlDeviceGetMemoryInfo": [_dev, ctypes.POINTER(Memory)],
    "nvmlDeviceGetPowerUsage": [_dev, _uint_p],
    "nvmlDeviceGetTemperature": [_dev, ctypes.c_int, _uint_p],
    "nvmlDeviceGetEnforcedPowerLimit": [_dev, _uint_p],
    "nvmlDeviceGetComputeRunningProcesses_v3": [_dev, _uint_p,
                                                ctypes.POINTER(ProcessInfo)],
}


class Nvml:
    """An initialised NVML: handles by UUID and the readings the device
    probe records. ``lib`` is the loaded library (default: ``path`` through
    `ctypes.CDLL`, which raises `OSError` when it is missing)."""

    def __init__(self, lib: Any = None, path: str = LIBRARY):
        self.lib = ctypes.CDLL(path) if lib is None else lib
        for name, args in _PROTOTYPES.items():
            fn = getattr(self.lib, name, None)
            if fn is not None:
                fn.argtypes, fn.restype = args, ctypes.c_int
        errstr = getattr(self.lib, "nvmlErrorString", None)
        if errstr is not None:
            errstr.argtypes, errstr.restype = [ctypes.c_int], ctypes.c_char_p
        self._call("nvmlInit_v2")
        self._open = True

    def _text(self, code: int) -> str:
        errstr = getattr(self.lib, "nvmlErrorString", None)
        if errstr is None:
            return ""
        raw = errstr(code)
        return raw.decode(errors="replace") if isinstance(raw, bytes) else \
            str(raw or "")

    def _call(self, name: str, *args) -> None:
        code = getattr(self.lib, name)(*args)
        if code != NVML_SUCCESS:
            raise NvmlError(name, code, self._text(code))

    def _uint(self, name: str, *args) -> int:
        out = ctypes.c_uint(0)
        self._call(name, *args, ctypes.byref(out))
        return out.value

    # -- handles ----------------------------------------------------------
    def handle(self, uuid: str):
        """The device whose UUID is ``uuid`` (``GPU-...``, as
        `nvmlDeviceGetUUID` writes it and torch's
        ``get_device_properties(i).uuid`` names it without the prefix)."""
        out = _dev()
        self._call("nvmlDeviceGetHandleByUUID", uuid.encode(),
                   ctypes.byref(out))
        return out

    def uuid(self, handle) -> str:
        buf = ctypes.create_string_buffer(_UUID_LEN)
        self._call("nvmlDeviceGetUUID", handle, buf, _UUID_LEN)
        return buf.value.decode()

    # -- readings ----------------------------------------------------------
    def utilization(self, handle) -> Tuple[float, float]:
        """(kernel-busy %, memory-busy %) over NVML's last sample period."""
        u = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", handle, ctypes.byref(u))
        return float(u.gpu), float(u.memory)

    def memory(self, handle) -> Tuple[int, int, int]:
        """(total, free, used) bytes of the whole card."""
        m = Memory()
        self._call("nvmlDeviceGetMemoryInfo", handle, ctypes.byref(m))
        return int(m.total), int(m.free), int(m.used)

    def power_w(self, handle) -> float:
        return self._uint("nvmlDeviceGetPowerUsage", handle) / 1e3  # mW

    def temperature_c(self, handle) -> float:
        return float(self._uint("nvmlDeviceGetTemperature", handle,
                                NVML_TEMPERATURE_GPU))

    def power_limit_w(self, handle) -> float:
        return self._uint("nvmlDeviceGetEnforcedPowerLimit", handle) / 1e3

    def reading(self, handle) -> Dict[str, float]:
        """One sample in the device rows' units: util %, mem_gb (used, GiB
        as the rows' ``size = mem_gb * 2**30``), power_w, temp_c; with the
        card's total memory beside them (``hbm_gb``)."""
        util, _ = self.utilization(handle)
        total, _, used = self.memory(handle)
        return {"util": util, "mem_gb": used / 2**30,
                "power_w": self.power_w(handle),
                "temp_c": self.temperature_c(handle),
                "hbm_gb": total / 2**30}

    def process_memory(self, handle, pid: int) -> Tuple[bool, Optional[int]]:
        """(answered, bytes): ``pid``'s own memory on the card, the paper's
        process-level reading. ``answered`` is False where the GPU driver lacks
        the call or does not support it; bytes is None where the list holds
        no ``pid`` (in a container the GPU driver lists the host's PIDs)."""
        fn = getattr(self.lib, "nvmlDeviceGetComputeRunningProcesses_v3",
                     None)
        if fn is None:
            return False, None
        # twice the room the count allows: a GPU driver whose entry is wider
        # than this struct still writes inside the buffer
        infos = (ProcessInfo * (2 * _MAX_PROCS))()
        count = ctypes.c_uint(_MAX_PROCS)
        code = fn(handle, ctypes.byref(count), infos)
        if code in (NVML_ERROR_NOT_SUPPORTED, NVML_ERROR_FUNCTION_NOT_FOUND):
            return False, None
        if code != NVML_SUCCESS:
            raise NvmlError("nvmlDeviceGetComputeRunningProcesses_v3", code,
                            self._text(code))
        for info in infos[:min(count.value, _MAX_PROCS)]:
            if info.pid == pid:
                return True, int(info.usedGpuMemory)
        return True, None

    def shutdown(self) -> None:
        if self._open:
            self._open = False
            self._call("nvmlShutdown")
