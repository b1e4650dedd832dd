"""Device time of a function on the card.

``cuda_ms`` times back-to-back calls as the host issues them, by CUDA
events; ``graph_ms`` replays the calls from one CUDA graph, so a short
kernel's time does not include the host's work between launches;
``kernel_ms`` sums the device time of every kernel the calls launch, from
``torch.profiler``, for work that cannot be captured in a graph and whose
span the host's launches set; ``kernel_split_ms`` gives the same time by
kernel name.
"""

import torch


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the launches follow each other on the card with
    no gaps for the host's work between them."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # relaxed: the launchers query the device and set kernel attributes
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / reps


def kernel_split_ms(fn, reps):
    """{kernel name: mean device time per call} of the kernels (and
    copies and fills) that ``fn`` launches, over ``reps`` calls traced by
    ``torch.profiler``."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 / reps
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def kernel_ms(fn, reps):
    """Mean device time of the kernels (and copies and fills) that ``fn``
    launches, over ``reps`` calls traced by ``torch.profiler``: the card's
    busy time, without the gaps in which it waits for the host."""
    return sum(kernel_split_ms(fn, reps).values())
