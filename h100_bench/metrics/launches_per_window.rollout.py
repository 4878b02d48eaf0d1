"""Device operations (kernels, copies, sets) the host enqueued over the
profiled stretch, for each fed-back window of a test batch."""

from h100_bench.readers import per_unit_launches


def read(record, window, cfg):
    return per_unit_launches(record, "windows")
