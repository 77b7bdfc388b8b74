"""High-level simulation model facades (counterpart of
mathaudio_tpu/models): the FEM room model with its frequency-major ELL
sweep (``helmholtz_room``) and the node-major DIA sweep
(``room_sweep_nm``)."""

from mathaudio_tpu_torch.models.helmholtz_room import RoomSweepModel  # noqa: F401
