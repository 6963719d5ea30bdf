"""The whole scoring step's share of the card's peak, in %: the counted
operations of the rows the model scored (by the configuration's family; no
padding, no cache hits) over the window times 67 TOP/s."""
from portbench import catalog, stats, work


def read(records, cfg):
    batches = records.get("batches", [])
    seconds = stats.window_s(records)
    if not batches or seconds <= 0:
        return None
    batch_ops = catalog.family(cfg).batch_ops
    ops = sum(batch_ops(cfg, rows) for rows in batches)
    return 100.0 * ops / (seconds * work.NON_TENSOR_OPS_PER_S)
