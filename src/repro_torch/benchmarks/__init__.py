"""repro_torch.benchmarks: the paper-figure and kernel benchmarks on the port.

One module per script of the reference's ``benchmarks/`` directory, each
run as ``python -m repro_torch.benchmarks.<name>``, or all through
:mod:`repro_torch.benchmarks.run`.  Every ``main`` keeps the reference's
signature and adds ``device=None``: the card, as every entry point of the
port; ``device="cpu"`` runs it on the CPU.  The figures print the
reference's ``figure,series,step,test_accuracy`` rows and keep its gates;
the timing scripts write ``BENCH_torch_*.json`` at the repository's root,
each with the device's name and power limit.
"""
