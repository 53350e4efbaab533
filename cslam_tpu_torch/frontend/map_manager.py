"""Map manager: runs sensor handlers periodically.

Port of cslam_tpu/frontend/map_manager.py (the reference MapManager<T>:
a timer calling process_new_sensor_data() at
frontend.map_manager_process_period_ms, and the component's dispatch on
the sensor type).
"""

from typing import Dict

from cslam_tpu_torch.device import DeviceLike


class MapManager:
    """Drives one sensor handler; the host runtime calls tick() at the
    configured period."""

    def __init__(self, handler, params: Dict):
        self.handler = handler
        self.period_ms = params.get("frontend.map_manager_process_period_ms",
                                    100)
        self.processed = 0

    def tick(self):
        result = self.handler.process_new_sensor_data()
        if result is not None:
            self.processed += 1
        return result


def make_sensor_handler(params: Dict, bus, clock, device: DeviceLike = None):
    """Sensor-type dispatch on `device` (None = the CUDA card): stereo /
    rgbd -> the RGBD-family handler, lidar -> LidarHandler."""
    sensor_type = params.get("frontend.sensor_type", "stereo").lower()
    if sensor_type == "lidar":
        from cslam_tpu_torch.frontend.lidar_handler import LidarHandler
        return LidarHandler(params, bus, clock, device=device)
    from cslam_tpu_torch.frontend.rgbd_handler import RGBDHandler, \
        StereoHandler
    cls = StereoHandler if sensor_type == "stereo" else RGBDHandler
    return cls(params, bus, clock, device=device)
