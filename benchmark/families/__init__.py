"""The model families the benchmark runs, one module each:
``benchmark/families/<family>.py``, found by the ``"family"`` key of a
configuration's file (``harness/registry.py`` ``family``). The generic
harness (``harness/runner.py``, ``harness/weights.py``, ``control.py``)
asks a family module for everything that depends on the model:

Weights
    ``parts(cfg)``: [(part, file name, leaves)], each leaf (key, shape,
    kind), drawn and written by ``weights.write`` beside the sidecar
    ``cfg[part]``, so a part is named by its key in the configuration. ``SHAPES``
    (optional): {kind: initialiser(view, shape)} for kinds that
    ``weights._shape`` lacks.
The system
    ``write_inputs(mix, seed, out_dir)``: the files its calls read (for
    example reference voices); ``build(cfg, mix, paths, inputs, device,
    seed, rec)``: the system under test from the written weights, with the
    benchmark's wrappers recording into ``rec`` (``harness/system.py``
    ``Recorder``); ``kernels(cfg, device)``: what set-up must build.
Warm-up and call
    ``warm(system)``: the work a returning user's system has done before
    the warm-up call; ``draw(mix, seed, i)``: the drawn inputs of call
    ``i`` (negative: warm-up), planned before the window; ``call(system,
    drawn, i)``: one call, inside ``rec.span("call")``, returning what the
    check judges.
Accounting
    ``attempted(out)`` and ``samples(out)``: the items a call asked for and
    the audio samples it returned; ``sample_rate(cfg)``; ``model_flops(run)``:
    the model FLOP of the window's calls; ``failed(cfg, mix, calls)``: the
    items whose output is missing or malformed; ``counters()``: the
    program's counters, read before and after the window
    (``run.counters`` holds the differences).
Checking
    ``readings(cfg, mix, paths, device, calls, seed)``: the numbers
    compared with ``cfg["limits"]``, from a plain reference that reads the
    same weight and input files; ``numbers(cfg)``: their names (every
    configuration has a limit for each, ``tests/test_bench_spec.py``).
    For ``control.py``: ``CHECK_CALLS``, the calls it makes a seed, and
    ``control_calls(cfg, mix, seed, n_calls, device, paths, inputs)``, the
    reference one precision lower in the program's place, its outputs
    shaped as ``call``'s. For ``benchmark/tests/tiny.py``: ``tiny(cfg, mix,
    texts, steps)``, the configuration and mix cut for rehearsals on the
    CPU.

A family may add what its own metric readers ask of a run (``sv2tts``:
``decode_steps(run)``); a reader returns None in a cell whose family
gives it nothing to read. Adding a family adds its module, its
configurations, mixes, cells and metrics as new files and entries, and
edits none of the harness (``tests/test_bench_family.py`` adds a toy
family, ``tests/toy_family.py``, to a copy of the benchmark so).
"""
