from repro_torch.data.scenarios import (
    ARRIVAL_KINDS, NPB_LARGE, NPB_SMALL, bursty_arrivals, diurnal_arrivals,
    maintenance_windows, make_arrivals, make_stream_workload,
    poisson_arrivals, sample_programs,
)
