"""Global detector config tree with YAML merge.

The port's own copy of ``tpu3d/config/config.py`` (numpy + yaml only), so that
``tpu3d_torch`` imports nothing of ``tpu3d``. Keys, defaults and merge rules
are the same as there and as pointrcnn/lib/config.py: unknown keys are
rejected, types are checked, arrays are coerced, and dotted ``--set``
overrides (``cfg_from_list``) behave as there. easydict is replaced by a
tiny AttrDict.
"""

from __future__ import annotations

import numpy as np

class AttrDict(dict):
    """dict with attribute access (stand-in for easydict.EasyDict)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name, value):
        self[name] = value

    @classmethod
    def from_nested(cls, d):
        out = cls()
        for k, v in d.items():
            out[k] = cls.from_nested(v) if hasattr(v, "items") else v
        return out


def as_attrdict(d) -> "AttrDict":
    """Recursively coerce any mapping (e.g. flax FrozenDict, which linen turns
    dict-valued module attributes into) back to attribute-access AttrDict."""
    if isinstance(d, AttrDict):
        return d
    return AttrDict.from_nested(d)


def _default_cfg() -> AttrDict:
    """Defaults identical to pointrcnn/lib/config.py:5-181."""
    c = AttrDict()
    c.TAG = "default"
    c.CLASSES = "Car"
    c.INCLUDE_SIMILAR_TYPE = False
    # BF16_INFERENCE and TRAIN.{REMAT, BF16_ACTIVATIONS, BF16_MATMULS} are
    # the JAX package's precision knobs (no reference counterpart).
    # BF16_INFERENCE puts every Dense of an eval forward in bf16, on any
    # device (precision.resolve reads it). TRAIN.BF16_ACTIVATIONS and
    # TRAIN.BF16_MATMULS set the training contract on the card
    # (train_numerics, which precision.resolve reads); TRAIN.REMAT, the
    # recomputed backbone, is not ported and raises there.
    c.BF16_INFERENCE = False

    c.AUG_DATA = True
    c.AUG_METHOD_LIST = ["rotation", "scaling", "flip"]
    c.SCALE_MIN_MAX_RANGE = [0.95, 1.05]
    c.AUG_METHOD_PROB = [0.5, 0.5, 0.5]
    c.AUG_ROT_RANGE = 18

    c.GT_AUG_ENABLED = False
    c.GT_EXTRA_NUM = 15
    c.GT_AUG_RAND_NUM = False
    c.GT_AUG_APPLY_PROB = 0.75
    c.GT_AUG_HARD_RATIO = 0.6

    c.PC_REDUCE_BY_RANGE = True
    c.PC_AREA_SCOPE = np.array([[-40, 40], [-1, 3], [0, 70.4]])
    c.CLS_MEAN_SIZE = np.array([[1.52, 1.63, 3.88]], dtype=np.float32)

    c.RPN = AttrDict(
        ENABLED=True, FIXED=False, USE_INTENSITY=True,
        LOC_XZ_FINE=False, LOC_SCOPE=3.0, LOC_BIN_SIZE=0.5, NUM_HEAD_BIN=12,
        BACKBONE="pointnet2_msg", USE_BN=True, NUM_POINTS=16384,
        SA_CONFIG=AttrDict(
            NPOINTS=[4096, 1024, 256, 64],
            RADIUS=[[0.1, 0.5], [0.5, 1.0], [1.0, 2.0], [2.0, 4.0]],
            NSAMPLE=[[16, 32], [16, 32], [16, 32], [16, 32]],
            MLPS=[[[16, 16, 32], [32, 32, 64]],
                  [[64, 64, 128], [64, 96, 128]],
                  [[128, 196, 256], [128, 196, 256]],
                  [[256, 256, 512], [256, 384, 512]]],
        ),
        FP_MLPS=[[128, 128], [256, 256], [512, 512], [512, 512]],
        CLS_FC=[128], REG_FC=[128], DP_RATIO=0.5,
        LOSS_CLS="DiceLoss", FG_WEIGHT=15, FOCAL_ALPHA=[0.25, 0.75],
        FOCAL_GAMMA=2.0, REG_LOSS_WEIGHT=[1.0, 1.0, 1.0, 1.0],
        LOSS_WEIGHT=[1.0, 1.0], NMS_TYPE="normal", SCORE_THRESH=0.3,
    )

    c.RCNN = AttrDict(
        ENABLED=False, USE_RPN_FEATURES=True, USE_MASK=True, MASK_TYPE="seg",
        USE_INTENSITY=False, USE_DEPTH=True, USE_SEG_SCORE=False,
        ROI_SAMPLE_JIT=False, ROI_FG_AUG_TIMES=10, REG_AUG_METHOD="multiple",
        POOL_EXTRA_WIDTH=1.0,
        LOC_SCOPE=1.5, LOC_BIN_SIZE=0.5, NUM_HEAD_BIN=9, LOC_Y_BY_BIN=False,
        LOC_Y_SCOPE=0.5, LOC_Y_BIN_SIZE=0.25, SIZE_RES_ON_ROI=False,
        USE_BN=False, DP_RATIO=0.0, BACKBONE="pointnet",
        XYZ_UP_LAYER=[128, 128], NUM_POINTS=512,
        SA_CONFIG=AttrDict(
            NPOINTS=[128, 32, -1], RADIUS=[0.2, 0.4, 100],
            NSAMPLE=[64, 64, 64],
            MLPS=[[128, 128, 128], [128, 128, 256], [256, 256, 512]],
        ),
        CLS_FC=[256, 256], REG_FC=[256, 256],
        LOSS_CLS="BinaryCrossEntropy", FOCAL_ALPHA=[0.25, 0.75],
        FOCAL_GAMMA=2.0, CLS_WEIGHT=np.array([1.0, 1.0, 1.0], dtype=np.float32),
        CLS_FG_THRESH=0.6, CLS_BG_THRESH=0.45, CLS_BG_THRESH_LO=0.05,
        REG_FG_THRESH=0.55, FG_RATIO=0.5, ROI_PER_IMAGE=64, HARD_BG_RATIO=0.6,
        SCORE_THRESH=0.3, NMS_THRESH=0.1,
    )

    c.TRAIN = AttrDict(
        SPLIT="train", VAL_SPLIT="smallval",
        LR=0.002, LR_CLIP=0.00001, LR_DECAY=0.5,
        DECAY_STEP_LIST=[50, 100, 150, 200, 250, 300],
        LR_WARMUP=False, WARMUP_MIN=0.0002, WARMUP_EPOCH=5,
        BN_MOMENTUM=0.9, BN_DECAY=0.5, BNM_CLIP=0.01,
        BN_DECAY_STEP_LIST=[50, 100, 150, 200, 250, 300],
        OPTIMIZER="adam", WEIGHT_DECAY=0.0, MOMENTUM=0.9,
        MOMS=[0.95, 0.85], DIV_FACTOR=10.0, PCT_START=0.4,
        GRAD_NORM_CLIP=1.0,
        REMAT=False, BF16_ACTIVATIONS=True, BF16_MATMULS=True,
        RPN_PRE_NMS_TOP_N=12000, RPN_POST_NMS_TOP_N=2048,
        RPN_NMS_THRESH=0.85, RPN_DISTANCE_BASED_PROPOSE=True,
    )

    c.TEST = AttrDict(
        SPLIT="val", RPN_PRE_NMS_TOP_N=9000, RPN_POST_NMS_TOP_N=300,
        RPN_NMS_THRESH=0.7, RPN_DISTANCE_BASED_PROPOSE=True,
    )
    return c


cfg = _default_cfg()


def _merge_a_into_b(a: dict, b: AttrDict) -> None:
    """Clobber b with a; unknown keys and type mismatches raise
    (reference parity: lib/config.py:193-220)."""
    if not isinstance(a, dict):
        return
    for k, v in a.items():
        if k not in b:
            raise KeyError(f"{k} is not a valid config key")
        old_type = type(b[k])
        if old_type is not type(v):
            if isinstance(b[k], np.ndarray):
                v = np.array(v, dtype=b[k].dtype)
            elif isinstance(b[k], float) and isinstance(v, int):
                v = float(v)
            elif not (isinstance(b[k], AttrDict) and isinstance(v, dict)):
                raise ValueError(
                    f"Type mismatch ({old_type} vs. {type(v)}) for config key: {k}")
        if isinstance(b[k], AttrDict):
            _merge_a_into_b(v, b[k])
        else:
            b[k] = v


def train_numerics(c) -> tuple[bool, bool]:
    """(BF16_ACTIVATIONS, BF16_MATMULS) of config ``c``'s TRAIN block, read
    as tpu3d's gates read them (True where unset, and for ``c`` None);
    raises for ``TRAIN.REMAT``, whose recomputed backbone (tpu3d:
    models/rpn.py:84-88) is not ported yet."""
    train = {} if c is None else c.get("TRAIN", {})
    if bool(train.get("REMAT", False)):
        raise NotImplementedError(
            "TRAIN.REMAT (the backbone recomputed in the backward) is not "
            "ported yet: it is the next slice's, beside kernel 9's bf16 "
            "training form")
    return (bool(train.get("BF16_ACTIVATIONS", True)),
            bool(train.get("BF16_MATMULS", True)))


def cfg_from_file(filename: str, target: AttrDict | None = None) -> AttrDict:
    """Merge a YAML file into the global (or given) config."""
    import yaml

    with open(filename) as f:
        yaml_cfg = yaml.safe_load(f)
    _merge_a_into_b(yaml_cfg, target if target is not None else cfg)
    return target if target is not None else cfg


def fresh_cfg() -> AttrDict:
    """A new independent default config (tests / multi-config runs)."""
    return _default_cfg()


def cfg_from_list(cfg_list, target: AttrDict | None = None) -> AttrDict:
    """Dotted key/value overrides, e.g. ['TRAIN.LR', '0.01']
    (reference parity: lib/config.py:223-242)."""
    from ast import literal_eval

    c = target if target is not None else cfg
    assert len(cfg_list) % 2 == 0
    for k, v in zip(cfg_list[0::2], cfg_list[1::2]):
        key_list = k.split(".")
        d = c
        for subkey in key_list[:-1]:
            assert subkey in d, f"unknown config key {k}"
            d = d[subkey]
        subkey = key_list[-1]
        assert subkey in d, f"unknown config key {k}"
        try:
            value = literal_eval(v)
        except (ValueError, SyntaxError):
            value = v
        if isinstance(d[subkey], float) and isinstance(value, int):
            value = float(value)
        if isinstance(d[subkey], np.ndarray):
            value = np.array(value, dtype=d[subkey].dtype)
        else:
            assert type(value) is type(d[subkey]), \
                f"type {type(value)} does not match original type {type(d[subkey])}"
        d[subkey] = value
    return c


def save_config_to_file(c: AttrDict, pre: str = "cfg", logger=None) -> None:
    for key, val in c.items():
        if isinstance(val, AttrDict):
            msg = f"\n{pre}.{key} = edict()"
            logger.info(msg) if logger else print(msg)
            save_config_to_file(val, pre=f"{pre}.{key}", logger=logger)
            continue
        msg = f"{pre}.{key}: {val}"
        logger.info(msg) if logger else print(msg)

