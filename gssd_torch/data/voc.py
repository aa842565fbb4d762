"""Pascal VOC detection dataset (VOCdevkit layout): the port of
``gssd_tpu/data/voc.py``.

Items are ([1, H, W, 3] float 0..255 images, [n, 4] normalised boxes,
[n] labels), so the port's ``collate`` / ``BatchLoader`` /
``pad_targets`` make [B, size, size, 3] NHWC batches with max_gt-padded
targets, the contract of every other dataset of the port. The matching
model config is ``ssd_type='ssd', num_phases=1, slices_per_phase=3,
num_classes=21`` (the 3-channel vanilla SSD300, the upstream fork's
baseline). The JPEGs are read by OpenCV (``cv2.imread``, imported where
an image is read, so that importing the port loads no OpenCV).
``write_voc_tree`` writes a small synthetic tree for tests and smoke
runs, as ``make_synthetic_dataset`` does for the CT sets.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

import numpy as np

# the VOC label contract; index = position
VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat",
    "bottle", "bus", "car", "cat", "chair",
    "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant",
    "sheep", "sofa", "train", "tvmonitor",
)

_CLASS_TO_IND = {name: i for i, name in enumerate(VOC_CLASSES)}


def parse_voc_annotation(
    root: "ET.Element",
    width: float,
    height: float,
    keep_difficult: bool = False,
    class_to_ind: Optional[dict] = None,
    return_difficult: bool = False,
):
    """VOC XML root -> [n, 5] f32 (xmin, ymin, xmax, ymax, label), the
    coordinates normalised by the image size after the shift from
    1-based to 0-based pixels; difficult objects drop unless
    keep_difficult. With return_difficult, every object is kept and an
    [n] bool difficult-flag array comes alongside (the evaluation ignores
    difficult objects, so it needs them flagged, not dropped)."""
    lookup = class_to_ind or _CLASS_TO_IND
    rows: List[List[float]] = []
    flags: List[bool] = []
    for obj in root.iter("object"):
        diff = obj.find("difficult")
        is_diff = diff is not None and int(diff.text) == 1
        if not return_difficult and not keep_difficult and is_diff:
            continue
        name = obj.find("name").text.lower().strip()
        bb = obj.find("bndbox")
        coords = [
            (int(bb.find(pt).text) - 1) / (width if i % 2 == 0 else height)
            for i, pt in enumerate(("xmin", "ymin", "xmax", "ymax"))
        ]
        rows.append(coords + [float(lookup[name])])
        flags.append(is_diff)
    anno = (np.asarray(rows, np.float32) if rows
            else np.zeros((0, 5), np.float32))
    if return_difficult:
        return anno, np.asarray(flags, bool)
    return anno


class VOCDataset:
    """VOCdevkit reader with the ``LesionDataset`` item protocol:
    __getitem__ -> (img [1, H, W, 3] float 0..255, boxes [n, 4]
    normalised, labels [n] float), transformed if a transform is given;
    pull_image / pull_anno return the untransformed originals.
    ``image_sets``: (year, set name) pairs, e.g. [("2007", "trainval")]."""

    def __init__(
        self,
        root: str,
        image_sets: Sequence[Tuple[str, str]] = (("2007", "trainval"),),
        transform: Optional[Callable] = None,
        keep_difficult: bool = False,
    ):
        self.root = root
        self.transform = transform
        self.keep_difficult = keep_difficult
        self.ids: List[Tuple[str, str]] = []
        for year, name in image_sets:
            rootpath = os.path.join(root, "VOC" + year)
            listing = os.path.join(
                rootpath, "ImageSets", "Main", name + ".txt")
            with open(listing) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        self.ids.append((rootpath, line))

    def __len__(self) -> int:
        return len(self.ids)

    def _paths(self, index: int) -> Tuple[str, str]:
        rootpath, img_id = self.ids[index]
        return (
            os.path.join(rootpath, "JPEGImages", img_id + ".jpg"),
            os.path.join(rootpath, "Annotations", img_id + ".xml"),
        )

    def pull_image(self, index: int) -> np.ndarray:
        """Original image as [H, W, 3] RGB float 0..255."""
        import cv2

        bgr = cv2.imread(self._paths(index)[0], cv2.IMREAD_COLOR)
        if bgr is None:
            raise FileNotFoundError(self._paths(index)[0])
        return bgr[:, :, ::-1].astype(np.float32)

    def pull_anno(self, index: int) -> np.ndarray:
        """[n, 5] boxes normalized to the original image + class."""
        img_path, xml_path = self._paths(index)
        root = ET.parse(xml_path).getroot()
        size = root.find("size")
        w = float(size.find("width").text)
        h = float(size.find("height").text)
        return parse_voc_annotation(
            root, w, h, keep_difficult=self.keep_difficult)

    def pull_anno_with_difficult(self, index: int):
        """([n, 5] normalised boxes + class, [n] difficult flags) with the
        difficult objects kept, for the evaluation, which ignores them."""
        _, xml_path = self._paths(index)
        root = ET.parse(xml_path).getroot()
        size = root.find("size")
        w = float(size.find("width").text)
        h = float(size.find("height").text)
        return parse_voc_annotation(root, w, h, return_difficult=True)

    def raw_item(self, index: int) -> Tuple[np.ndarray, np.ndarray]:
        img = self.pull_image(index)
        target = self.pull_anno(index)
        return img, target

    def __getitem__(self, index: int):
        img, target = self.raw_item(index)
        # a single phase axis: the [P, H, W, C] layout of the CT sets
        img = img[None]
        boxes = target[:, :4]
        labels = target[:, 4]
        if self.transform is not None:
            img, boxes, labels = self.transform(img, boxes, labels)
        return img, boxes, labels


def write_voc_tree(root: str, objects: Mapping[str, Sequence], sizes: Optional[Mapping] = None,
                   image_sets: Optional[Mapping[str, Sequence[str]]] = None,
                   year: str = "2007", seed: int = 0) -> str:
    """Write a VOCdevkit tree under ``root``: for each image of ``objects``
    ({name: [(class, (xmin, ymin, xmax, ymax) 1-based, difficult), ...]})
    a JPEG (OpenCV; uniform noise, brighter inside each object's box) of
    ``sizes[name]`` = (h, w) pixels (128 x 160 without ``sizes``) and its
    XML annotation; ``image_sets`` {set name: image names} (default
    {"trainval": every image}). Returns the ``VOC<year>`` directory."""
    import cv2

    base = os.path.join(root, "VOC" + year)
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    rng = np.random.default_rng(seed)
    for name, objs in objects.items():
        h, w = sizes[name] if sizes else (128, 160)
        img = rng.uniform(0, 160, (h, w, 3))
        ann = ET.Element("annotation")
        size = ET.SubElement(ann, "size")
        for tag, v in (("width", w), ("height", h), ("depth", 3)):
            ET.SubElement(size, tag).text = str(v)
        for cls, box, diff in objs:
            img[box[1] - 1:box[3], box[0] - 1:box[2]] += 80
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = cls
            ET.SubElement(obj, "difficult").text = str(int(diff))
            bb = ET.SubElement(obj, "bndbox")
            for tag, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
                ET.SubElement(bb, tag).text = str(v)
        cv2.imwrite(os.path.join(base, "JPEGImages", name + ".jpg"),
                    np.clip(img, 0, 255).astype(np.uint8))
        ET.ElementTree(ann).write(os.path.join(base, "Annotations", name + ".xml"))
    for set_name, names in (image_sets or {"trainval": list(objects)}).items():
        with open(os.path.join(base, "ImageSets", "Main", set_name + ".txt"), "w") as fh:
            fh.write("\n".join(names) + "\n")
    return base
