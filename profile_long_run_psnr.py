"""Where eval_long_run's PSNR comes from: the full lane of
`vings_mono_tpu_torch.runners.eval_long_run` at its defaults (320 frames,
no baseline), with `eval_psnr` taken as the lane takes it and again after
every row that storage paged out to the host is paged back in. Prints
one JSON line: both PSNRs and the row counts on the device and the host
before and after.

Usage: python profile_long_run_psnr.py [--out FILE] [eval_long_run args]

Runs on CUDA (the entry point's default); pass --device cpu for the CPU.
"""

import json
import sys

import numpy as np


def main(argv=None):
    from vings_mono_tpu_torch.runners import eval_long_run, evaluate
    from vings_mono_tpu_torch.runners import run as run_mod

    storages = []
    build = run_mod.build

    def rec(cfg, device=None):
        parts = build(cfg, device=device)
        storages.append(parts[3])
        return parts

    psnr = evaluate.eval_psnr
    found = {}

    def both(mapper, tracker, n_eval=10):
        as_is = psnr(mapper, tracker, n_eval)
        storage = storages[-1]
        found.update(psnr_as_is=as_is, host_rows_before=storage.n_host,
                     alive_before=int(mapper.n_alive))
        # every saved keyframe within the paging distance: all rows back
        storage.cpu2gpu(mapper, np.zeros(len(storage.place)))
        mapper.invalidate_binning()
        found.update(psnr_all_paged_in=psnr(mapper, tracker, n_eval),
                     host_rows_after=storage.n_host,
                     alive_after=int(mapper.n_alive))
        return as_is

    run_mod.build, evaluate.eval_psnr = rec, both
    try:
        eval_long_run.main(["--skip-baseline"] + list(
            sys.argv[1:] if argv is None else argv))
    finally:
        run_mod.build, evaluate.eval_psnr = build, psnr
    print(json.dumps(found), flush=True)
    return found


if __name__ == "__main__":
    main()
