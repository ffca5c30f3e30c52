"""Inverse elastodynamics: infer material parameters from sparse sensors.

Counterpart of ``pinn_elastodynamics_tpu/cases/inverse.py`` (BASELINE.json
config #5): E and rho become trainable leaves optimized jointly with the
network parameters; supervision is sparse displacement sensors plus the
same PDE residuals.  The mixed-variable formulation makes this natural:
the constitutive residual ties the stress outputs to strains through the
unknown E, and the momentum residual ties stress gradients to
accelerations through the unknown rho.

Material parameters are optimized in log-space (positivity and better
conditioning): ``E = exp(log_E)`` and ``rho = exp(log_rho)`` are 0-d
tensors inside :class:`~..ops.elasticity.Material`, so gradients reach
both.  The sensor bank carries observed (u, v) and stresses at scattered
spacetime points, sampled from FEM frames of the confined-wave case, so
the answer is the reference's E=2.5, rho=1.0
(ElasticWaveConfined/ElasticWave.py:33-35).

**Identifiability**: with displacement-only observations and
displacement-driven boundary conditions, the joint scale of (E, rho) is
not identifiable — scaling both by alpha scales sigma and rho*u_tt
equally — and only the wave speed c^2 ~ E/rho is.  Observing stress at the
sensors anchors the scale; finite-difference accelerations at the sensors
(``accel_weight``) anchor rho.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..banks import PointBank, make_bank, masked_mean_square
from ..device import resolve_device
from ..models.fields import FieldSpec, FIRST_ORDER, MLPFieldModel
from ..ops import residuals as res_ops
from ..ops.elasticity import Material, PLANE_STRAIN
from . import wave_confined


@dataclasses.dataclass(frozen=True)
class InverseProblem:
    """Joint (network, material) inverse problem."""

    name: str
    model: object
    plane: str
    mu: float                     # Poisson ratio held fixed (standard practice)
    E_init: float
    rho_init: float
    weights: Tuple[Tuple[str, float], ...] = (
        ("f_uv", 5.0), ("f_s", 5.0), ("DATA", 10.0), ("DATA_S", 10.0),
    )
    device: object = "cuda"       # where the parameters live

    def init_params(self, seed: int = 1111, dtype=torch.float32):
        """Network parameters drawn from a ``torch.Generator`` seeded with
        ``seed``, and the log-material leaves at ``E_init`` and
        ``rho_init``, on the problem's device."""
        gen = torch.Generator().manual_seed(seed)
        dev = resolve_device(self.device)
        log = lambda v: torch.as_tensor(np.log(v), dtype=dtype, device=dev)
        return {
            "net": self.model.init(gen, dtype, dev),
            "log_E": log(self.E_init),
            "log_rho": log(self.rho_init),
        }

    def material(self, params) -> Material:
        return Material(
            E=torch.exp(params["log_E"]),
            mu=self.mu,
            rho=torch.exp(params["log_rho"]),
        )

    def loss_and_aux(self, params, banks: Dict[str, PointBank],
                     *, collector=None):
        mat = self.material(params)
        spec = self.model.spec
        net = params["net"]

        def mms(name, r, mask):
            # As losses/terms.MaskedSums: feed the extended-precision chunk
            # collector (banks.ChunkSumCollector) so the host-f64 engine
            # (train/lbfgs_host.py) can drive the inverse problem too.
            if collector is not None:
                collector.add(name, r, mask)
            return masked_mean_square(r, mask)

        jet = self.model.jet(net, banks["collocation"].xyt)
        res = res_ops.residuals(jet, spec, mat, self.plane)
        cmask = banks["collocation"].mask
        comps = {
            "f_uv": sum(mms("f_uv", res[n], cmask)
                        for n in res_ops.momentum_group(spec)),
            "f_s": sum(mms("f_s", res[n], cmask)
                       for n in res_ops.stress_group(spec)),
        }

        sens = banks["sensors"]
        iu, iv = spec.index("u"), spec.index("v")
        if "att" in sens.values:
            # Acceleration supervision: rho is only identified through
            # div sigma = rho·u_tt at collocation points, where u_tt is the
            # net's unanchored second derivative; matching the net's u_tt
            # to finite-difference accelerations from adjacent FEM frames
            # anchors exactly that direction.
            sjet = self.model.jet(net, sens.xyt, order=2)
            fields = sjet.f
            a_obs = sens.values["att"]
            comps["DATA_TT"] = (
                mms("DATA_TT", sjet.dtt[:, iu] - a_obs[:, 0], sens.mask)
                + mms("DATA_TT", sjet.dtt[:, iv] - a_obs[:, 1], sens.mask)
            )
        else:
            fields = self.model.apply(net, sens.xyt)
        obs = sens.values["uv"]
        comps["DATA"] = (
            mms("DATA", fields[:, iu] - obs[:, 0], sens.mask)
            + mms("DATA", fields[:, iv] - obs[:, 1], sens.mask)
        )
        if "s" in sens.values:
            # Stress observations: the scale anchor (see module docstring).
            s_obs = sens.values["s"]
            comps["DATA_S"] = sum(
                mms("DATA_S",
                    fields[:, spec.index(ch)] - s_obs[:, j], sens.mask)
                for j, ch in enumerate(("s11", "s22", "s12"))
            )

        wmap = dict(self.weights)
        total = sum(wmap.get(k, 0.0) * v for k, v in comps.items())
        comps["E"] = mat.E
        comps["rho"] = mat.rho
        return total, comps

    def loss_fn(self, banks) -> Callable:
        def fn(params):
            total, _ = self.loss_and_aux(params, banks)
            return total

        return fn


def sensors_from_fem(
    fem_dir: str,
    frames,
    frame_time: Callable,
    *,
    n_per_frame: int = 200,
    offset: Tuple[float, float] = (0.0, 0.0),
    seed: int = 0,
    accel: bool = False,
):
    """Sample sparse (x, y, t) sensor points + observed (u, v) from FEM frames.

    With ``accel=True`` also returns central-difference accelerations
    (u_tt, v_tt) from the adjacent frames at the same sensor locations —
    the rho-identifying observable (see :func:`build`).  Frames must then
    have both neighbors on disk.
    """
    from ..eval import fem as fem_mod

    rng = np.random.default_rng(seed)
    pts, uv, s, att = [], [], [], []
    for f in frames:
        d = fem_mod.load_frame(fem_dir, f)
        idx = rng.choice(d["x"].shape[0], size=n_per_frame, replace=False)
        t = frame_time(f)
        pts.append(np.stack([
            d["x"][idx] + offset[0], d["y"][idx] + offset[1],
            np.full(n_per_frame, t),
        ], axis=1))
        uv.append(np.stack([d["u"][idx], d["v"][idx]], axis=1))
        s.append(np.stack([d["s11"][idx], d["s22"][idx], d["s12"][idx]],
                          axis=1))
        if accel:
            dm = fem_mod.load_frame(fem_dir, int(f) - 1)
            dp = fem_mod.load_frame(fem_dir, int(f) + 1)
            dt = frame_time(int(f) + 1) - frame_time(int(f))
            att.append(np.stack([
                (dp["u"][idx] - 2 * d["u"][idx] + dm["u"][idx]) / dt**2,
                (dp["v"][idx] - 2 * d["v"][idx] + dm["v"][idx]) / dt**2,
            ], axis=1))
    out = (np.concatenate(pts), np.concatenate(uv), np.concatenate(s))
    if accel:
        return out + (np.concatenate(att),)
    return out


def build(
    *, seed: int = 1111, scale: float = 1.0, dtype=torch.float32,
    pad_to_multiple_of: int = 1, E_init: float = 1.0, rho_init: float = 0.5,
    n_sensor_frames: int = 20, sensors_per_frame: int = 200,
    accel_weight: float = 0.0, fem_dir: Optional[str] = None,
    jet_impl: str = "auto", device="cuda",
) -> Tuple[InverseProblem, Dict[str, PointBank]]:
    """Inverse confined-wave problem with FEM sensor data, its banks on
    ``device`` (``"cuda"`` unless the caller asks for the CPU).

    Returns (problem, banks); true answer E=2.5, rho=1.0.  ``fem_dir``
    holds the confined case's FEM frames (default
    ``wave_confined.FEM_DIR``, relative to the current directory).

    ``accel_weight > 0`` adds finite-difference acceleration supervision
    at the sensors (DATA_TT) — the rho-identifying observable (see
    :meth:`InverseProblem.loss_and_aux`); the sensor frames are then
    clamped so both FD neighbors exist.  The model is 3 -> 140 x 6 -> 7
    with ``jet_impl`` (default ``"auto"``: the fused kernels on the GPU).
    """
    rng = np.random.default_rng(seed)
    max_t = 14.0
    s = lambda n: max(8, int(round(n * scale)))

    model = MLPFieldModel(
        spec=FieldSpec(ndim=2, formulation=FIRST_ORDER),
        hidden=(140,) * 6, jet_impl=jet_impl,
    )

    from ..geometry import sampling as smp

    col = smp.lhs_box((-15, -15, 0.0), (15, 15, max_t), s(120000), rng)
    col = smp.exclude_disk(col, xc=0, yc=0, r=2.0, strict=True)

    accel = accel_weight > 0
    frames = np.linspace(2 if accel else 1, 55 if accel else 56,
                         n_sensor_frames).astype(int)
    out = sensors_from_fem(
        wave_confined.FEM_DIR if fem_dir is None else fem_dir, frames,
        lambda f: f * max_t / 56,
        n_per_frame=s(sensors_per_frame) if scale < 1 else sensors_per_frame,
        offset=(-15.0, -15.0), seed=seed, accel=accel,
    )
    pts, uv, s_obs = out[:3]

    mk = lambda p, v=None: make_bank(
        p, v, dtype=dtype, pad_to_multiple_of=pad_to_multiple_of,
        device=device,
    )
    sensor_values = {"uv": uv, "s": s_obs}
    if accel:
        sensor_values["att"] = out[3]
    banks = {
        "collocation": mk(col),
        "sensors": mk(pts, sensor_values),
    }
    kw = {}
    if accel:
        base_w = InverseProblem.__dataclass_fields__["weights"].default
        kw["weights"] = tuple(base_w) + (("DATA_TT", accel_weight),)
    problem = InverseProblem(
        name="inverse_confined_wave",
        model=model,
        plane=PLANE_STRAIN,
        mu=0.25,
        E_init=E_init,
        rho_init=rho_init,
        device=device,
        **kw,
    )
    return problem, banks
