"""Shared room-acoustics types, geometry, sources, config and output
(counterpart of mathaudio_tpu/common): the layer below both simulation
engines. The JSON config schema loads the same files as the reference.
"""

from mathaudio_tpu_torch.common.types import (  # noqa: F401
    Point3D,
    SurfaceElement,
    RoomMesh,
    SPEED_OF_SOUND,
    AIR_DENSITY,
    REFERENCE_PRESSURE,
)
from mathaudio_tpu_torch.common.source import (  # noqa: F401
    Source,
    DirectivityPattern,
    CrossoverFilter,
)
from mathaudio_tpu_torch.common.geometry import (  # noqa: F401
    RoomGeometry,
    RectangularRoom,
    LShapedRoom,
)
from mathaudio_tpu_torch.common.config import (  # noqa: F401
    RoomConfig,
    RoomSimulation,
    SurfaceSpec,
    FrequencySpec,
    SolverSpec,
    load_room_config,
)
from mathaudio_tpu_torch.common.output import (  # noqa: F401
    FrequencyResult,
    SimulationResults,
    create_output_json,
    create_output_json_with_sources,
    generate_spatial_slices,
    create_default_config,
)
