"""The benchmark of hfa_gp_tpu_torch on one NVIDIA H100.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a cell needs is found by name: its configuration in
`configs/<config>.json`, its traffic in `traffic/<traffic>.json` (the
entry it drives, the batch, the input pool), the entry in
`entries/<entry>.py`, the model's adapter in `models/<model>.py`, the
limits of its correctness check in `limits/<cell>.json`, and each metric's
reader in `metrics/<name>.py` (else `metrics/<name before its first
dot>.py`). The FLOP and byte counts live in `counts/`, the plain PyTorch
reference that decides `correct` in `reference/`; neither imports the
port.
"""
