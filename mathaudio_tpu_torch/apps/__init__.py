"""CLI applications of the port (counterpart of mathaudio_tpu/apps):

- autoeq: fit a parametric EQ to a measured response and export it

Run as ``python -m mathaudio_tpu_torch.apps.<name> --help``.
"""
