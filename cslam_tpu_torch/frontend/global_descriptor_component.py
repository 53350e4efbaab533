"""Global-descriptor extraction component.

Port of cslam_tpu/frontend/global_descriptor_component.py: consumes
KeyframeRGB from the sensor handler, computes the global descriptor
(CosPlace or NetVLAD, from `frontend.global_descriptor_technique`) and
publishes cslam/processed_global_descriptor for the loop-closure
detector. Keyframes are batched: pending images accumulate to
`batch_size` and one forward on `device` embeds the whole batch.
"""

from typing import Dict, List

import numpy as np

from cslam_tpu_torch.comm import messages as msgs
from cslam_tpu_torch.device import DeviceLike


class GlobalDescriptorComponent:

    def __init__(self, params: Dict, bus, model=None,
                 batch_size: int = 8, device: DeviceLike = None):
        """model: any object with compute_embedding (and optionally
        compute_embeddings_batch); None builds the configured technique's
        wrapper with its weights on `device` (None = the CUDA card)."""
        self.params = params
        self.bus = bus
        self.batch_size = batch_size
        if model is not None:
            self.model = model
        else:
            technique = params.get("frontend.global_descriptor_technique",
                                   "cosplace").lower()
            if technique == "netvlad":
                from cslam_tpu_torch.models.netvlad import NetVLAD
                self.model = NetVLAD(params, device=device)
            else:
                from cslam_tpu_torch.models.cosplace import CosPlace
                self.model = CosPlace(params, device=device)
        self.pending: List[msgs.KeyframeRGB] = []
        self.publisher = bus.create_publisher(
            "cslam/processed_global_descriptor")
        bus.subscribe("cslam/keyframe_data", self.receive_keyframe)

    def receive_keyframe(self, msg):
        if isinstance(msg, msgs.KeyframeRGB):
            self.pending.append(msg)
            if len(self.pending) >= self.batch_size:
                self.flush()

    def flush(self):
        """Embed all pending keyframes in one batched forward."""
        if not self.pending:
            return 0
        batch = self.pending
        self.pending = []
        if hasattr(self.model, "compute_embeddings_batch"):
            # grey keyframes are broadcast to 3 channels
            images = np.stack([
                np.broadcast_to(m.image, m.image.shape[:2] + (3,))
                if m.image.shape[2] == 1 else m.image for m in batch
            ])
            embeddings = self.model.compute_embeddings_batch(images)
        else:
            embeddings = [
                self.model.compute_embedding(m.image) for m in batch
            ]
        for m, emb in zip(batch, embeddings):
            self.publisher.publish(
                msgs.GlobalDescriptor(
                    keyframe_id=m.id,
                    robot_id=self.params["robot_id"],
                    descriptor=np.asarray(emb, dtype=np.float32)))
        return len(batch)

    def tick(self):
        """Periodic flush, so a partial batch does not wait for a full
        one."""
        return self.flush()
