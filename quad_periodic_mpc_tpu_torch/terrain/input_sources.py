"""Config-driven multi-sensor input routing into the elevation map
(counterpart of ``quad_periodic_mpc_tpu/terrain/input_sources.py``).

Rebuilds elevation_mapping's InputSourceManager / Input pair
(elevation_mapping/src/input_sources/InputSourceManager.cpp:16-79,
Input.cpp:23-115): a declarative configuration maps named input sources
(each with a type, topic, queue size, publish flag, and a sensor
processor) onto the map-fusion pipeline.  The ROS-specific machinery
(parameter server, subscribers) becomes a plain dict config + host-side
registry; the per-source sensor processor dispatches to the batched
variance models in `terrain/sensor.py`, and `process` feeds a source's
point cloud through `sensor.process_points` into
`heightmap.fuse_points` — the rebuild of the
pointCloudCallback → sensor processor → ElevationMap::add chain
(ElevationMapping.cpp pointCloudCallback).

Validation semantics mirror the reference exactly (it is gtest-covered
there, InputSourcesTest.cpp:24-75):

- an empty list configures zero sources and SUCCEEDS
  (InputSourceManager.cpp:30-33);
- a non-mapping configuration fails (:35-42);
- every source must carry `type` (str), `topic` (str), `queue_size`
  (int), `publish_on_update` (bool) and a `sensor_processor` mapping
  (Input.cpp:34-51) — a missing or mis-typed member rejects that
  source;
- a negative queue_size rejects the source (Input.cpp:57-62);
- an unknown sensor_processor type rejects the source
  (Input.cpp:95-110);
- subscribing the same topic twice keeps the first source, drops the
  duplicate, and reports overall failure
  (InputSourceManager.cpp:58-68).

Failed sources never abort configuration of the remaining ones — the
manager keeps every valid source and returns success=False, exactly the
reference's `successfulConfiguration` accumulation
(InputSourceManager.cpp:44-71).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping

import torch

from quad_periodic_mpc_tpu_torch.terrain import heightmap as hm_lib
from quad_periodic_mpc_tpu_torch.terrain import sensor as sensor_lib

# sensor_processor "type" → model factory (Input.cpp:95-110's dispatch;
# parameters beyond "type" forward to the model dataclass fields).
SENSOR_PROCESSORS: dict[str, Callable[..., Any]] = {
    "structured_light": sensor_lib.StructuredLightModel,
    "stereo": sensor_lib.StereoModel,
    "laser": sensor_lib.LaserModel,
    "perfect": sensor_lib.PerfectModel,
}

_REQUIRED_MEMBERS: tuple[tuple[str, type], ...] = (
    ("type", str),
    ("topic", str),
    ("queue_size", int),
    ("publish_on_update", bool),
    ("sensor_processor", Mapping),
)


@dataclasses.dataclass(frozen=True)
class InputSource:
    """One configured input (Input.hpp): a named point-cloud stream and
    its sensor-processor model."""

    name: str
    type: str                      # e.g. "pointcloud", "depthimage"
    topic: str
    queue_size: int
    publish_on_update: bool
    processor: Any                 # a terrain.sensor model instance

    def process(
        self,
        hm: hm_lib.HeightMap,
        points_sensor: torch.Tensor,
        R_map_base: torch.Tensor,
        R_base_sensor: torch.Tensor,
        t_base_sensor: torch.Tensor,
        t_map_base: torch.Tensor,
        rotation_covariance: torch.Tensor | None = None,
        min_variance: float = 1e-9,
        mahalanobis_threshold: float = 0.0,
        pixel_ij: torch.Tensor | None = None,
    ) -> hm_lib.HeightMap:
        """Sensor-frame cloud → map-frame fusion (the reference's
        pointCloudCallback tail: PassThrough depth cutoff +
        computeVariances + ElevationMap::add).  Points outside the
        sensor's depth cutoff (StereoSensorProcessor.cpp:99-111) are
        excluded from fusion entirely."""
        p_map, var = sensor_lib.process_points(
            points_sensor, self.processor, R_map_base, R_base_sensor,
            t_base_sensor, t_map_base, rotation_covariance,
            pixel_ij=pixel_ij,
        )
        var = torch.clamp(var, min=min_variance)
        mask = None
        depth_mask = getattr(self.processor, "depth_mask", None)
        if depth_mask is not None:
            mask = depth_mask(points_sensor)
            # masked-out points also get +inf variance so any consumer of
            # (p_map, var) without the mask still sees them as weightless
            var = torch.where(mask, var, torch.full_like(var, math.inf))
        return hm_lib.fuse_points(
            hm, p_map, var, mahalanobis_threshold=mahalanobis_threshold,
            valid_mask=mask,
        )


class InputSourceManager:
    """Validates a declarative input-source config and owns the source
    list (InputSourceManager.hpp)."""

    def __init__(self) -> None:
        self.sources: list[InputSource] = []
        self.errors: list[str] = []
        self.routing: list[tuple[InputSource, Callable]] = []

    # -- configuration ------------------------------------------------
    def configure(self, config: Any) -> bool:
        """Returns overall success; valid sources are kept either way.

        `config = None` models the unset ROS namespace
        (InputSourceManager.cpp:17-26): warn + no sources + failure.
        """
        if config is None:
            self.errors.append("input sources configuration not set")
            return False
        if isinstance(config, (list, tuple)) and len(config) == 0:
            return True  # explicit "no inputs" (InputSourceManager.cpp:30-33)
        if not isinstance(config, Mapping):
            self.errors.append(
                f"input sources specification must be a mapping, got "
                f"{type(config).__name__}"
            )
            return False

        ok = True
        # repeated configure() calls extend the source list; duplicate
        # detection must see topics from earlier calls too
        seen_topics: set[str] = {s.topic for s in self.sources}
        for name, params in config.items():
            source = self._configure_one(str(name), params)
            if source is None:
                ok = False
                continue
            if source.topic in seen_topics:  # keep-first (cpp:58-68)
                self.errors.append(
                    f"{name}: duplicate subscription to {source.topic}"
                )
                ok = False
                continue
            seen_topics.add(source.topic)
            self.sources.append(source)
        return ok

    def _configure_one(self, name: str, params: Any) -> InputSource | None:
        if not isinstance(params, Mapping):
            self.errors.append(f"{name}: source must be a mapping")
            return None
        for member, mtype in _REQUIRED_MEMBERS:
            if member not in params:
                self.errors.append(f"{name}: missing member '{member}'")
                return None
            value = params[member]
            # bool is an int subclass in Python; keep the reference's
            # strict XmlRpc type check (Input.cpp:42-50)
            if mtype is int and isinstance(value, bool):
                self.errors.append(f"{name}: '{member}' has wrong type")
                return None
            if not isinstance(value, mtype):
                self.errors.append(f"{name}: '{member}' has wrong type")
                return None
        if params["queue_size"] < 0:  # Input.cpp:57-62
            self.errors.append(f"{name}: negative queue_size")
            return None

        proc_cfg = dict(params["sensor_processor"])
        proc_type = proc_cfg.pop("type", None)
        factory = SENSOR_PROCESSORS.get(proc_type)
        if factory is None:  # Input.cpp:95-110
            self.errors.append(
                f"{name}: unknown sensor processor type {proc_type!r}"
            )
            return None
        try:
            processor = factory(**proc_cfg)
        except TypeError as e:
            self.errors.append(f"{name}: bad sensor processor params: {e}")
            return None

        return InputSource(
            name=name,
            type=params["type"],
            topic=params["topic"],
            queue_size=params["queue_size"],
            publish_on_update=params["publish_on_update"],
            processor=processor,
        )

    # -- queries (InputSourceManager.hpp) ------------------------------
    def number_of_sources(self) -> int:
        return len(self.sources)

    def topics(self) -> list[str]:
        return [s.topic for s in self.sources]

    def register_callbacks(self, handlers: Mapping[str, Callable]) -> bool:
        """Type → handler registration (InputSourceManager::
        registerCallbacks, used by InputSourcesTest UnknownType): fails
        if any configured source's type has no handler; returns the
        (source, handler) routing otherwise via `self.routing`.  A failed
        call clears any previous routing (no stale state)."""
        self.routing = []
        routing = []
        for s in self.sources:
            h = handlers.get(s.type)
            if h is None:
                self.errors.append(f"{s.name}: no handler for type {s.type}")
                return False
            routing.append((s, h))
        self.routing = routing
        return bool(routing) or not self.sources
