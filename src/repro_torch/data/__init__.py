from repro_torch.data.scenarios import (
    ARRIVAL_KINDS, NPB_LARGE, NPB_SMALL, SWF_PHASE_FRACTIONS, TraceJob,
    bursty_arrivals, diurnal_arrivals, load_swf, maintenance_windows,
    make_arrivals, make_stream_workload, poisson_arrivals, sample_programs,
    swf_lines, synthetic_swf_arrays, workload_from_arrays,
    workload_from_swf, workload_from_trace,
)
from repro_torch.data.synthetic import (
    EOS, PAD, DataConfig, SyntheticStream, device_batch, host_batch,
)
