"""GraspNet-OS category tables (static dataset facts).

Copy of ``openset_rcnn_tpu/data/graspnet_meta.py``, kept in the port so
that it imports nothing of the JAX package.

The 88 GraspNet-1Billion categories with their COCO-JSON ids and the 28
known-category subset of the GraspNet-OS benchmark, as published by the
reference (openset_rcnn/data/graspnet_meta.py:1-113). These are dataset
constants, reproduced for behavioral parity.
"""

GRASPNET_CATEGORIES = [
    (1, "cracker_box"),
    (2, "sugar_box"),
    (3, "tomato_soup_can"),
    (4, "mustard_bottle"),
    (5, "potted_meat_can"),
    (6, "banana"),
    (7, "bowl"),
    (8, "mug"),
    (9, "power_drill"),
    (10, "scissors"),
    (11, "chips_can"),
    (12, "strawberry"),
    (13, "apple"),
    (14, "lemon"),
    (15, "peach"),
    (16, "pear"),
    (17, "orange"),
    (18, "plum"),
    (19, "knife"),
    (20, "phillips_screwdriver"),
    (21, "flat_screwdriver"),
    (22, "racquetball"),
    (23, "b_cups"),
    (24, "d_cups"),
    (25, "a_toy_airplane"),
    (26, "c_toy_airplane"),
    (27, "d_toy_airplane"),
    (28, "f_toy_airplane"),
    (29, "h_toy_airplane"),
    (30, "i_toy_airplane"),
    (31, "j_toy_airplane"),
    (32, "k_toy_airplane"),
    (33, "padlock"),
    (34, "dragon"),
    (35, "secret_repair"),
    (36, "jvr_cleansing_foam"),
    (37, "dabao_wash_soup"),
    (38, "nzskincare_mouth_rinse"),
    (39, "dabao_sod"),
    (40, "soap_box"),
    (41, "kispa_cleanser"),
    (42, "darlie_toothpaste"),
    (43, "nivea_men_oil_control"),
    (44, "baoke_marker"),
    (45, "hosjam"),
    (46, "pitcher_cap"),
    (47, "dish"),
    (48, "white_mouse"),
    (49, "camel"),
    (50, "deer"),
    (51, "zebra"),
    (52, "large_elephant"),
    (53, "rhinocero"),
    (54, "small_elephant"),
    (55, "monkey"),
    (56, "giraffe"),
    (57, "gorilla"),
    (58, "weiquan"),
    (59, "darlie_box"),
    (60, "soap"),
    (61, "black_mouse"),
    (62, "dabao_facewash"),
    (63, "pantene"),
    (64, "head_shoulders_supreme"),
    (65, "thera_med"),
    (66, "dove"),
    (67, "head_shoulders_care"),
    (68, "lion"),
    (69, "coconut_juice_box"),
    (70, "hippo"),
    (71, "tape"),
    (72, "rubiks_cube"),
    (73, "peeler_cover"),
    (74, "peeler"),
    (75, "ice_cube_mould"),
    (76, "bar_clamp"),
    (77, "climbing_hold"),
    (78, "endstop_holder"),
    (79, "gearbox"),
    (80, "mount1"),
    (81, "mount2"),
    (82, "nozzle"),
    (83, "part1"),
    (84, "part3"),
    (85, "pawn"),
    (86, "pipe_connector"),
    (87, "turbine_housing"),
    (88, "vase"),
]

GRASPNET_KNOWN_CATEGORIES = [
    "cracker_box", "tomato_soup_can", "banana", "mug", "power_drill", "scissors",
    "strawberry", "peach", "plum", "knife", "flat_screwdriver", "racquetball",
    "b_cups", "d_toy_airplane", "f_toy_airplane", "i_toy_airplane",
    "j_toy_airplane", "dabao_sod", "darlie_toothpaste", "camel",
    "large_elephant", "rhinocero", "darlie_box", "black_mouse",
    "dabao_facewash", "pantene", "head_shoulders_supreme", "head_shoulders_care",
]

_NAME_TO_ID = {name: cid for cid, name in GRASPNET_CATEGORIES}
GRASPNET_KNOWN_IDS = [_NAME_TO_ID[n] for n in GRASPNET_KNOWN_CATEGORIES]


def graspnet_metadata():
    """thing_classes + dataset-id -> contiguous-id map (d2-metadata shape)."""
    thing_ids = [cid for cid, _ in GRASPNET_CATEGORIES]
    assert len(thing_ids) == 88
    return {
        "thing_classes": [name for _, name in GRASPNET_CATEGORIES],
        "thing_dataset_id_to_contiguous_id": {cid: i for i, cid in enumerate(thing_ids)},
    }
