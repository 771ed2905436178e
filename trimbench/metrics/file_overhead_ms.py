"""Mean of total_run minus the parallel_scan[*] phases (the program's own
MVT_METRICS_JSON phases_us) per file counted: the probe, the detectors'
construction and warm-up, the segmentation and the cut hand-off."""


def read(run):
    rows = []
    for f in run.counted():
        phases = run.phases.get(f.path, {}).get("phases_us", {})
        if "total_run" in phases:
            scan = sum(v for k, v in phases.items()
                       if k.startswith("parallel_scan["))
            rows.append((phases["total_run"] - scan) / 1e3)
    return sum(rows) / len(rows) if rows else None
