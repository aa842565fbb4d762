"""Configuration of the PyTorch port: models, anchor grid and Detect head.

A copy of the parts of ``gssd_tpu/config.py`` the serving and training
paths need, so that the port runs on a host that has no JAX. Field names and defaults
are the JAX package's, so one flag set builds the same model in both.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class AnchorConfig:
    name: str
    feature_maps: Tuple[int, ...]
    min_dim: int
    steps: Tuple[int, ...]
    min_sizes: Tuple[int, ...]
    max_sizes: Tuple[int, ...]
    aspect_ratios: Tuple[Tuple[float, ...], ...]
    variance: Tuple[float, float] = (0.1, 0.2)
    clip: bool = True

    @property
    def num_priors_per_cell(self) -> Tuple[int, ...]:
        """Boxes per feature-map cell per scale."""
        if self.name == "v1":
            # legacy v1: min square, sqrt(min*max) square only when
            # max > 0, one box per ar != 1
            return tuple(
                1 + (1 if mx > 0 else 0)
                + sum(1 for ar in ars if abs(ar - 1) >= 1e-6)
                for ars, mx in zip(self.aspect_ratios, self.max_sizes)
            )
        return tuple(2 + 2 * len(ars) for ars in self.aspect_ratios)

    @property
    def num_priors(self) -> int:
        return sum(
            f * f * n
            for f, n in zip(self.feature_maps, self.num_priors_per_cell)
        )


V2 = AnchorConfig(
    name="v2",
    feature_maps=(38, 19, 10, 5, 3, 1),
    min_dim=300,
    steps=(8, 16, 32, 64, 100, 300),
    min_sizes=(30, 60, 111, 162, 213, 264),
    max_sizes=(60, 111, 162, 213, 264, 315),
    aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)

V2_CUSTOM = AnchorConfig(
    name="v2_custom",
    feature_maps=(38, 19, 10, 5, 3, 1),
    min_dim=300,
    steps=(8, 16, 32, 64, 100, 300),
    min_sizes=(30, 60, 111, 162, 213, 264),
    max_sizes=(60, 111, 162, 213, 264, 315),
    aspect_ratios=((2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)

V2_CUSTOM_SQUAREONLY = dataclasses.replace(
    V2_CUSTOM, name="v2_custom_squareonly", aspect_ratios=V2.aspect_ratios
)

V2_512 = AnchorConfig(
    name="v2_512",
    feature_maps=(64, 32, 16, 8, 4, 2, 1),
    min_dim=512,
    steps=(8, 16, 32, 64, 128, 256, 512),
    min_sizes=(20, 51, 133, 215, 296, 378, 460),
    max_sizes=(51, 133, 215, 296, 378, 460, 542),
    aspect_ratios=((2,), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)

V2_CUSTOM_512 = dataclasses.replace(
    V2_512,
    name="v2_custom_512",
    aspect_ratios=((2, 3), (2, 3), (2, 3), (2, 3), (2, 3), (2,), (2,)),
)

V1 = AnchorConfig(
    name="v1",
    feature_maps=(38, 19, 10, 5, 3, 1),
    min_dim=300,
    steps=(8, 16, 32, 64, 100, 300),
    min_sizes=(30, 60, 114, 168, 222, 276),
    max_sizes=(-1, 114, 168, 222, 276, 330),
    aspect_ratios=(
        (1, 1, 2, 1 / 2),
        (1, 1, 2, 1 / 2, 3, 1 / 3),
        (1, 1, 2, 1 / 2, 3, 1 / 3),
        (1, 1, 2, 1 / 2, 3, 1 / 3),
        (1, 1, 2, 1 / 2, 3, 1 / 3),
        (1, 1, 2, 1 / 2, 3, 1 / 3),
    ),
)

ANCHOR_CONFIGS = {
    c.name: c
    for c in (V2, V2_CUSTOM, V2_CUSTOM_SQUAREONLY, V2_512, V2_CUSTOM_512, V1)
}


@dataclass(frozen=True)
class ModelConfig:
    # 'ssd' = no grouping, 'gssd' = grouped convs + 1x1 fuse convs
    ssd_type: str = "gssd"
    size: int = 300
    num_classes: int = 2  # background + lesion
    num_phases: int = 4
    slices_per_phase: int = 3  # 3 adjacent axial slices per phase
    batch_norm: bool = True
    groups_vgg: int = 4
    groups_extra: int = 4
    feature_scale: int = 1
    use_fuseconv: bool = True
    use_self_attention: bool = False
    use_self_attention_base: bool = False
    num_dcn_layers: int = 0
    groups_dcn: int = 1
    dcn_cat_sab: bool = False
    detach_sab: bool = False
    max_pool_factor: int = 1
    anchors: str = "v2"
    # compute dtype for conv/matmul activations; params stay f32
    compute_dtype: str = "bfloat16"
    # deformable-conv core (ops/deform_conv.py resolve_deform_impl):
    # 'hat' runs the hat DCN's CUDA kernels (ops/kernels/deform_hat.py:
    # bf16 sampling and weights, f32 accumulation, like the JAX hat
    # kernel); 'pallas' the separable sampler's kernels
    # (ops/kernels/deform_sample.py); 'fused' the patch gather with an
    # analytic backward (ops/deform_fused.py); 'xla' the plain 4-corner
    # gather in the compute dtype (the f32 parity reference)
    dcn_impl: str = "hat"
    # recompute the self-attention blocks in the backward (--remat_attention)
    remat_attention: bool = False

    def __post_init__(self):
        if self.detach_sab and not self.dcn_cat_sab:
            raise ValueError("detach_sab requires dcn_cat_sab=True")
        if self.dcn_cat_sab and not self.use_self_attention_base:
            raise ValueError("dcn_cat_sab requires use_self_attention_base=True")
        if self.dcn_cat_sab and self.num_dcn_layers <= 0:
            # the slice_and_cat concat exists only to feed the DCN
            raise ValueError("dcn_cat_sab requires num_dcn_layers > 0")

    @property
    def in_channels(self) -> int:
        return self.num_phases * self.slices_per_phase  # 12

    @property
    def anchor_config(self) -> AnchorConfig:
        return ANCHOR_CONFIGS[self.anchors]


@dataclass(frozen=True)
class PixelLinkConfig:
    """PixelLink++ model, target and decoder settings
    (gssd_tpu/config.py:257-287)."""

    version: str = "4s"  # '2s' or '4s'
    pixel_weight: float = 2.0
    link_weight: float = 1.0
    neg_pos_ratio: int = 3
    min_area: int = 3
    min_height: int = 1
    pixel_conf_threshold: float = 0.2
    link_conf_threshold: float = 0.8
    vgg_groups: int = 4
    feature_scale: int = 1
    dilation: bool = True
    use_fuseconv: bool = True
    use_self_attention: bool = False
    use_self_attention_base: bool = False
    num_dcn_layers: int = 0
    groups_dcn: int = 1
    dcn_cat_sab: bool = False
    detach_sab: bool = False
    max_pool_factor: int = 1
    # recompute every attention block in the backward, as the JAX package
    # does by default (its reference checkpoints every PixelLink Self_Attn)
    remat_attention: bool = True

    def __post_init__(self):
        if self.detach_sab and not self.dcn_cat_sab:
            raise ValueError("detach_sab requires dcn_cat_sab=True")
        if self.dcn_cat_sab and not self.use_self_attention_base:
            raise ValueError("dcn_cat_sab requires use_self_attention_base=True")
        if self.dcn_cat_sab and self.num_dcn_layers <= 0:
            raise ValueError("dcn_cat_sab requires num_dcn_layers > 0")

    @property
    def scale_factor(self) -> int:
        return 2 if self.version == "2s" else 4


@dataclass(frozen=True)
class DetectConfig:
    """Detect head: decode + per-class greedy NMS."""

    num_classes: int = 2
    background_label: int = 0
    top_k: int = 200
    conf_thresh: float = 0.01
    nms_thresh: float = 0.45
    variance: Tuple[float, float] = (0.1, 0.2)


@dataclass(frozen=True)
class LossConfig:
    """MultiBox loss: matching threshold, OHNM ratio, box variances."""

    num_classes: int = 2
    overlap_thresh: float = 0.5
    neg_pos_ratio: int = 3  # --ohnm_neg_ratio
    variance: Tuple[float, float] = (0.1, 0.2)
    max_gt_boxes: int = 16  # static padding of variable-length targets


@dataclass(frozen=True)
class OptimConfig:
    """SGD with momentum and weight decay, LR stepped by ``gamma`` at
    ``stepvalues``, optional global-norm clip and x0.1 LR on dcn_*."""

    lr: float = 1e-3
    momentum: float = 0.9
    weight_decay: float = 5e-4
    gamma: float = 0.1
    stepvalues: Tuple[int, ...] = (30000, 50000)
    clip: Optional[float] = None  # global grad-norm clip
    modify_dcn_lr: bool = False  # x0.1 LR for DCN params
