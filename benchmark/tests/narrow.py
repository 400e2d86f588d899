"""A narrow detector and tiny traffic for the CPU tests: the cells' own
files with widths, canvases, top-k sizes and batches cut down (the pool
forced to the paired form, which on CPU tensors runs its plain version)."""
from __future__ import annotations

import copy

# the port's RPN head is 256 wide whatever the FPN's width, so the FPN keeps 256
OVERRIDES = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8, "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8, "MODEL.FPN.OUT_CHANNELS": 256, "MODEL.ROI_BOX_HEAD.FC_DIM": 64,
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100,
    "MODEL.RPN.PRE_NMS_TOPK_TEST": 200, "MODEL.RPN.POST_NMS_TOPK_TEST": 100,
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32, "MODEL.ROI_HEADS.POOLER_IMPL": "pallas",
    "PAD.CANVAS_BUCKETS": [[64, 96], [96, 64]], "PAD.MAX_GT_PER_IMAGE": 8,
    "INPUT.MIN_SIZE_TRAIN": [48, 56, 64], "INPUT.MAX_SIZE_TRAIN": 96, "INPUT.MIN_SIZE_TEST": 64,
    "INPUT.MAX_SIZE_TEST": 96, "SOLVER.IMS_PER_BATCH": 2, "DATALOADER.NUM_WORKERS": 2,
}
PHOTOS = [[48, 64, 2], [64, 48, 1]]
BOXES = {"count_lognormal": [1.0, 0.5], "count_range": [1, 8], "area_mix": [[4, 16, 0.5], [16, 40, 0.5]]}


def cell(c: dict) -> dict:
    c = copy.deepcopy(c)
    t = c["traffic"]
    t.update(batch=2, photos=PHOTOS, boxes=BOXES)
    if t.get("ranks", 1) > 1:
        t["ranks"] = 2  # two gloo ranks of one image
    if t["feed"] == "loader":
        t["tree"].update(images=16, photos=PHOTOS)
    else:
        t.update(canvases=t["canvases"][:3],
                 min_sizes=[64] if c["driver"] == "infer" else OVERRIDES["INPUT.MIN_SIZE_TRAIN"])
    if c["driver"] == "infer":
        c.update(check_batches=2, check_within=3, trace_steps=2)
    else:
        c.update(trace_steps=2)
    return c
