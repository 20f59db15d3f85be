"""Guard: the timed call runs every convolution of the models it times.

Counterpart of ``srbh_tpu/tools/_hlo.py``, which reads XLA's optimised HLO
to prove that no convolution of the timed train step was hoisted out of the
bench's ``fori_loop`` (``tests/test_bench_chains.py``). Eager PyTorch hoists
nothing; the port's risk is a timed call that leaves work out, such as SR
features computed once in the set-up and handed to every timed call. So the
guard records one call of the timed function with ``torch.profiler`` and
holds three counts against each other:

* the convolution modules of the models the tool says it times that one
  plain forward of the path calls (the ``reference``, run apart; RRDBNet's
  ``conv_last``, for one, is not on the feature path);
* the calls of those modules in the timed call (forward hooks): every one
  must run;
* the convolutions the profiler saw in the window (``aten::convolution``,
  and ``aten::_int_mm``, the int8 trunk's products): as many as the hooks
  counted, plus as many more as the reference made without a module (the
  space-to-depth and int8 layouts compute with a module's weights and do
  not call it), which the profiler counts in the reference too.

On a card the guard also holds a fourth count: the convolutions to which
the profiler tied device time (``profiled_on_device``: the cuDNN
implicit-GEMM, FFT or Winograd kernels, or cuBLAS's, that each launched),
as many as it saw. The guarded call is the second of two in the window,
and only its ops count (those inside its ``record_function`` range). In a
window opened on the guarded call itself, the card's trace lost the
kernels of its first few milliseconds in some runs on an H100 (their
launches recorded, the kernels not), and 1 to 10 of the 557 convolutions
of a serving step (float32 with TF32 on and off, and bfloat16) showed no
device time.
"""
from __future__ import annotations

import torch
from torch import nn

CONVS = (nn.Conv2d, nn.ConvTranspose2d)
CONV_OPS = ("aten::convolution", "aten::_int_mm")
GUARDED = "srbh_guarded_call"  # the profiler range of the call that counts


def conv_modules(*models) -> list:
    """The convolution modules of ``models`` (``None`` entries skipped)."""
    return [m for model in models if model is not None
            for m in model.modules() if isinstance(m, CONVS)]


def _calls(fn, convs) -> dict:
    """How often ``fn()`` calls each module of ``convs``, by ``id``."""
    calls = {id(m): 0 for m in convs}

    def count(m, args, out):
        calls[id(m)] += 1

    hooks = [m.register_forward_hook(count) for m in convs]
    fn()
    for h in hooks:
        h.remove()
    return calls


def check_convs(fn, reference, *models) -> dict:
    """Run ``fn()`` twice under the profiler and check that the second call
    calls every convolution of ``models`` that ``reference()`` (a plain
    forward of the same path, run first, outside the profiler) calls, that
    the profiler saw each call and, on a card, tied device time to each.
    Returns the counts; raises ``AssertionError`` naming what the timed
    call left out."""
    from torch.profiler import ProfilerActivity, profile, record_function

    convs = conv_modules(*models)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as ref:
        ref_calls = _calls(reference, convs)
    want = {k for k, n in ref_calls.items() if n}
    ref_unhooked = (sum(1 for e in ref.events() if e.name in CONV_OPS)
                    - sum(ref_calls.values()))
    cuda = torch.cuda.is_available() and any(
        p.is_cuda for model in models if model is not None
        for p in model.parameters())
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * cuda
    with profile(activities=activities) as prof:
        fn()  # the window's first milliseconds: the card's trace may lose them
        if cuda:
            torch.cuda.synchronize()
        with record_function(GUARDED):
            calls = _calls(fn, convs)
            if cuda:
                torch.cuda.synchronize()
    span = next(e.time_range for e in prof.events() if e.name == GUARDED)
    events = [e for e in prof.events() if e.name in CONV_OPS
              and span.start <= e.time_range.start
              and e.time_range.end <= span.end]
    record = {"conv_modules": len(want),
              "modules_called": sum(1 for k in want if calls[k]),
              "conv_calls": sum(calls.values()),
              "profiled_convs": len(events),
              "reference_unhooked": ref_unhooked,
              "profiled_on_device": (sum(1 for e in events
                                         if e.device_time_total > 0)
                                     if cuda else None)}
    missing = record["conv_modules"] - record["modules_called"]
    if missing:
        raise AssertionError(f"the timed call left out {missing} of "
                             f"{len(want)} convolution modules: {record}")
    if record["profiled_convs"] != record["conv_calls"] + ref_unhooked:
        raise AssertionError(f"the profiler saw {record['profiled_convs']} "
                             f"convolutions, the modules ran "
                             f"{record['conv_calls']} and the reference "
                             f"{ref_unhooked} more: {record}")
    if cuda and record["profiled_on_device"] != record["profiled_convs"]:
        raise AssertionError(f"the profiler tied device time to "
                             f"{record['profiled_on_device']} of "
                             f"{record['profiled_convs']} convolutions: {record}")
    return record
