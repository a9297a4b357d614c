"""QEC threshold analysis: logical vs physical error rate.

The port's twin of ``scripts/qec_threshold.py``, with its arguments,
defaults and JSON keys. Each sweep point's trials run as one batch on the
device. ``--engine frame`` runs the sweep on the Pauli-frame engine
(``qec_frame``): the same per-trial outcomes for the reference codes
under the same draws, and also repetition codes of any odd distance
(``--codes repetition:25`` / ``phase_repetition:25``) and rotated surface
codes at any odd distance (``--codes surface:9``); plain ``surface`` (d = 3)
runs on either engine.

Usage:
    python -m quantum_simulator_tpu_torch.scripts.qec_threshold \
        --codes bit_flip,steane --noise bit_flip [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..qec import (BitFlipCode, PhaseFlipCode, QECSimulator,
                   RotatedSurfaceCode, SteaneCode)
from ..qec_frame import (FrameQECSimulator, frame_spec_from_code,
                         repetition_frame_spec, surface_code_frame_spec)
from ..utils.cli import add_device_argument, emit, open_device

CODE_MAP = {
    "bit_flip": BitFlipCode,
    "phase_flip": PhaseFlipCode,
    "steane": SteaneCode,
    "surface": RotatedSurfaceCode,
}


def _parse_code(name: str):
    """'bit_flip' -> (name, None) | 'repetition:11' -> (kind, distance)."""
    if name in CODE_MAP:
        return name, None
    for prefix, kind in (("repetition:", "bit_flip"),
                         ("phase_repetition:", "phase_flip"),
                         ("surface:", "surface")):
        if name.startswith(prefix):
            try:
                distance = int(name[len(prefix):])
            except ValueError:
                return None, None
            if distance < 3 or distance % 2 == 0:
                return None, None
            return kind, distance
    return None, None


def _make_sim(code_name: str, engine: str, device):
    """-> (simulator, metadata dict). The frame engine mirrors the sweep
    API."""
    kind, distance = _parse_code(code_name)
    if distance is not None:
        if engine != "frame":
            raise SystemExit(
                f"{code_name} requires --engine frame (the statevector "
                "engine cannot hold arbitrary-distance codes)")
        if kind == "surface":
            # ML-parity syndromes need no ancillas (RotatedSurfaceCode).
            spec = surface_code_frame_spec(distance)
            ancillas = 0
        else:
            spec = repetition_frame_spec(distance, kind)
            ancillas = distance - 1
        meta = {"code": spec.name, "data_qubits": spec.data_qubits,
                "total_qubits": spec.data_qubits + ancillas,
                "code_distance": distance}
        return FrameQECSimulator(spec, device), meta

    code = CODE_MAP[code_name]()
    meta = {"code": code.name, "data_qubits": code.data_qubits,
            "total_qubits": code.total_qubits,
            "code_distance": code.code_distance}
    if engine == "frame":
        return FrameQECSimulator(frame_spec_from_code(code), device), meta
    return QECSimulator(code, device), meta


def run_threshold(code_name: str, noise_type: str, n_trials: int,
                  seed: int, engine: str = "statevector",
                  device=None) -> dict:
    sim, meta = _make_sim(code_name, engine, device)
    noise_probs = np.linspace(0.001, 0.3, 15).tolist()
    results = sim.threshold_sweep(noise_probs, n_trials=n_trials,
                                  noise_type=noise_type, seed=seed)
    sweep_data = [{
        "physical_rate": tp.physical_rate,
        "logical_rate": tp.logical_rate,
        "success_rate": tp.success_rate,
        "avg_fidelity": tp.avg_fidelity,
        "logical_z_fidelity": tp.logical_z_fidelity,
        "decoder_success_rate": tp.decoder_success_rate,
    } for tp in results]

    threshold_p = None
    for tp in results:
        if tp.logical_rate < tp.physical_rate:
            threshold_p = tp.physical_rate

    return {
        "code": meta["code"],
        "code_key": code_name,
        "noise_type": noise_type,
        "n_trials": n_trials,
        "data_qubits": meta["data_qubits"],
        "total_qubits": meta["total_qubits"],
        "code_distance": meta["code_distance"],
        "estimated_threshold": threshold_p,
        "sweep": sweep_data,
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="QEC threshold analysis")
    parser.add_argument(
        "--codes", type=str, default="bit_flip,steane",
        help="Comma-separated code names: bit_flip, phase_flip, steane, "
             "surface (d=3), surface:D / repetition:D / phase_repetition:D")
    parser.add_argument("--noise", type=str, default="bit_flip",
                        choices=["bit_flip", "phase_flip", "depolarizing"])
    parser.add_argument("--trials", type=int, default=100)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--output", type=str, default=None)
    parser.add_argument(
        "--engine", type=str, default="statevector",
        choices=["statevector", "frame"],
        help="frame = Pauli-frame GF(2) engine (draw-exact vs statevector "
             "for the reference codes; required for repetition:D codes)")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    code_names = [c.strip() for c in args.codes.split(",")]
    for name in code_names:
        if _parse_code(name)[0] is None:
            print(f"Unknown code: {name}. Available: {list(CODE_MAP)} "
                  "or repetition:D / phase_repetition:D / surface:D "
                  "(odd D >= 3)")
            return 1
    device = open_device(args.device, "qec_threshold")
    if device is None:
        return 1

    print(f"Running QEC threshold: codes={code_names}, noise={args.noise}, "
          f"trials={args.trials}, seed={args.seed}, engine={args.engine}, "
          f"device={device}")
    all_results = []
    for code_name in code_names:
        print(f"  Sweeping {code_name}...")
        result = run_threshold(code_name, args.noise, args.trials, args.seed,
                               engine=args.engine, device=device)
        all_results.append(result)
        est = result["estimated_threshold"]
        print(f"    {result['code']}: threshold ~ {est if est else 'N/A'}")

    emit({"experiment": "qec_threshold", "noise_type": args.noise,
          "seed": args.seed, "engine": args.engine, "codes": all_results},
         args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
