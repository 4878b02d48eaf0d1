"""Device operations (kernels, copies, sets) the host enqueued over the
profiled stretch, for each Adam step of the fleet."""

from h100_bench.readers import per_unit_launches


def read(record, window, cfg):
    return per_unit_launches(record, "steps")
