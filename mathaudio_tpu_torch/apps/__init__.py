"""CLI applications of the port (counterpart of mathaudio_tpu/apps):

- autoeq: fit a parametric EQ to a measured response and export it
- roomsim_fem / roomsim_bem: config-driven room simulation
- qa_suite_fem / qa_suite_bem: the analytical validation suites
- run_de: differential evolution on a registered test function
- benchmark_convergence: the strategy x function convergence sweep
- plot_de: convergence plots of the recorded DE traces (host only)
- plot_functions: surface plots and metadata of the test functions

Run as ``python -m mathaudio_tpu_torch.apps.<name> --help``.
"""
