"""results.json accumulator + results.txt table writer (a copy of
``ntire2022_esr_tpu/harness/results.py``).

Byte-format mirror of the reference's persistence (test_demo.py:493-498,
:537-563): results.json maps model_name -> metric dict and survives across
invocations (the de-facto resume mechanism); results.txt is the
tab-formatted human table.
"""

from __future__ import annotations

import json
import os
from typing import Dict


def load_results(json_path: str) -> Dict:
    if not os.path.exists(json_path):
        return {}
    with open(json_path, "r") as f:
        return json.load(f)


def save_results(json_path: str, results: Dict) -> None:
    with open(json_path, "w") as f:
        json.dump(results, f)


def write_table(txt_path: str, results: Dict, include_test: bool = False) -> None:
    if include_test:
        fmt = "{:20s}\t{:10s}\t{:10s}\t{:14s}\t{:14s}\t{:14s}\t{:10s}\t{:10s}\t{:8s}\t{:8s}\t{:8s}\n"
        s = fmt.format("Model", "Val PSNR", "Test PSNR", "Val Time [ms]", "Test Time [ms]",
                       "Ave Time [ms]", "Params [M]", "FLOPs [G]", "Acts [M]", "Mem [M]", "Conv")
    else:
        fmt = "{:20s}\t{:10s}\t{:14s}\t{:10s}\t{:10s}\t{:8s}\t{:8s}\t{:8s}\n"
        s = fmt.format("Model", "Val PSNR", "Val Time [ms]", "Params [M]", "FLOPs [G]",
                       "Acts [M]", "Mem [M]", "Conv")
    for k, v in results.items():
        val_psnr = f"{v['valid_ave_psnr']:2.2f}"
        val_time = f"{v['valid_ave_runtime']:3.2f}"
        num_param = f"{v['num_parameters']:2.3f}"
        flops = f"{v['flops']:2.2f}"
        acts = f"{v['activations']:2.2f}"
        mem = f"{v['valid_memory']:2.2f}"
        conv = f"{v['num_conv']:4d}"
        if include_test:
            test_psnr = f"{v['test_ave_psnr']:2.2f}"
            test_time = f"{v['test_ave_runtime']:3.2f}"
            ave_time = f"{(v['valid_ave_runtime'] + v['test_ave_runtime']) / 2:3.2f}"
            s += fmt.format(k, val_psnr, test_psnr, val_time, test_time, ave_time,
                            num_param, flops, acts, mem, conv)
        else:
            s += fmt.format(k, val_psnr, val_time, num_param, flops, acts, mem, conv)
    with open(txt_path, "w") as f:
        f.write(s)
