"""ctypes binding for the C++ preintegration core (csrc/preintegrate.cpp).

Built with the host C++ compiler at first use into `build/torch_kernels/`
(beside the CUDA libraries of utils/cuda_build.py), named by a hash of the
source and flags so that an edited source rebuilds. A failed build or load
raises: the inertial layer never carries on with the numpy loop instead.
`Preintegration.integrate` (tracker/imu.py) is the plain twin the tests hold
this against. One C call integrates a whole inter-keyframe batch."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

from ..utils.cuda_build import BUILD_DIR, CSRC

STATE_DOUBLES = 286
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]


def _cxx():
    for cand in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    raise RuntimeError("no C++ compiler found for csrc/preintegrate.cpp "
                       "(set CXX)")


def library_path():
    src = CSRC / "preintegrate.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpreintegrate-{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def get_lib():
    """The ctypes handle, built on first use; raises if it cannot be."""
    lib_path = library_path()
    if not lib_path.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [_cxx(), *CXX_FLAGS, "-o", str(tmp),
             str(CSRC / "preintegrate.cpp")], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building csrc/preintegrate.cpp failed "
                               f"({proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    d = ctypes.POINTER(ctypes.c_double)
    lib.preintegrate.argtypes = [d, d, ctypes.c_long, d, d, ctypes.c_double]
    lib.preintegrate.restype = None
    return lib


def pack_state(pre):
    """Preintegration -> flat (286,) float64 state vector."""
    s = np.zeros(STATE_DOUBLES, np.float64)
    s[0:9] = pre.dR.reshape(-1)
    s[9:12] = pre.dv
    s[12:15] = pre.dp
    s[15] = pre.dt
    s[16:25] = pre.J_Rbg.reshape(-1)
    s[25:34] = pre.J_vbg.reshape(-1)
    s[34:43] = pre.J_vba.reshape(-1)
    s[43:52] = pre.J_pbg.reshape(-1)
    s[52:61] = pre.J_pba.reshape(-1)
    s[61:286] = pre.cov.reshape(-1)
    return s


def unpack_state(pre, s):
    pre.dR = s[0:9].reshape(3, 3).copy()
    pre.dv = s[9:12].copy()
    pre.dp = s[12:15].copy()
    pre.dt = float(s[15])
    pre.J_Rbg = s[16:25].reshape(3, 3).copy()
    pre.J_vbg = s[25:34].reshape(3, 3).copy()
    pre.J_vba = s[34:43].reshape(3, 3).copy()
    pre.J_pbg = s[43:52].reshape(3, 3).copy()
    pre.J_pba = s[52:61].reshape(3, 3).copy()
    pre.cov = s[61:286].reshape(15, 15).copy()


def integrate_batch(pre, meas_rows):
    """meas_rows: (M, 7) float64 [dt, acc(3), gyro(3)] raw (bias-inclusive).
    Integrates into `pre` in place and logs the rows for re-integration."""
    if len(meas_rows) == 0:
        return
    lib = get_lib()
    state = pack_state(pre)
    meas = np.ascontiguousarray(meas_rows, np.float64)
    bias = np.concatenate([pre.bg, pre.ba]).astype(np.float64)
    p = pre.params
    noise = np.asarray([p.gyr_n, p.acc_n, p.gyr_w, p.acc_w], np.float64)
    d = ctypes.POINTER(ctypes.c_double)
    lib.preintegrate(state.ctypes.data_as(d), meas.ctypes.data_as(d),
                     ctypes.c_long(len(meas)), bias.ctypes.data_as(d),
                     noise.ctypes.data_as(d),
                     ctypes.c_double(p.integration_n))
    unpack_state(pre, state)
    for row in meas_rows:
        pre.meas.append((np.asarray(row[1:4]), np.asarray(row[4:7]),
                         float(row[0])))
