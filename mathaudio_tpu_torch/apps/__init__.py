"""CLI applications of the port (counterpart of mathaudio_tpu/apps):

- autoeq: fit a parametric EQ to a measured response and export it
- roomsim_bem: config-driven interior room BEM (the dense tiers)
- qa_suite_bem: the BEM analytical validation suite

Run as ``python -m mathaudio_tpu_torch.apps.<name> --help``.
"""
