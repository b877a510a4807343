"""Benchmark dataset registrations.

Port of ``enhax/data/datasets.py``: the ``DatasetSpec`` table (every row,
as data) and the dataset and datamodule classes generated from it, each
registered in ``DATASETS`` and ``DATAMODULES`` under the row's name. Every
dataset follows the layout ``root/<name>/<split>/image`` (or the row's
``dirs``), with ``ref_image`` from the sibling ``ref`` folder (and the
other names ``MultimodalDataset`` knows) and, for rows with ``depth``,
``depth`` from ``image_<source>``. SIDD: ``root/sidd/{train,test}/image``
and ``root/sidd/{train,test}/ref``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

from enhax_torch.constants import DATAMODULES, DATASETS, Split, Task
from enhax_torch.data.annotation import DatapointAttributes, DepthMapAnnotation, ImageAnnotation
from enhax_torch.data.datamodule import DataModule
from enhax_torch.data.dataset import MultimodalDataset, image_files


@dataclasses.dataclass
class DatasetSpec:
    name: str
    task: Task
    splits: tuple
    dirs: tuple = ()          # patterns with {split}; default: ("<name>/{split}/image",)
    paired: bool = True       # has ref_image
    depth: bool = False       # reference also lists depth variants for LLIE sets
    has_test_annotations: bool = False


_TT = (Split.TRAIN, Split.TEST)
_T = (Split.TEST,)
_TR = (Split.TRAIN,)

# Reference modules: src/mon/dataset/enhance/<file>.py
_SPECS = [
    # --- LLIE (lol_v1.py, lol_v2.py, sice.py, sid.py, fivek.py, dicm.py,
    # lime.py, mef.py, npe.py, vv.py, fusion.py, darkface.py, exdark.py,
    # ledlight.py, lighteffect.py, nightcity.py, loli_street.py, ulol.py,
    # lol_blur.py) ------------------------------------------------------------
    DatasetSpec("lol_v1", Task.LLIE, _TT, paired=True, depth=True, has_test_annotations=True),
    DatasetSpec("lol_v2_real", Task.LLIE, _TT, paired=True, depth=True, has_test_annotations=True),
    DatasetSpec("lol_v2_synthetic", Task.LLIE, _TT, paired=True, depth=True,
                has_test_annotations=True),
    DatasetSpec("lol_blur", Task.LLIE, _TT, paired=True, has_test_annotations=True),
    DatasetSpec("sice", Task.LLIE, _TT, paired=True),
    DatasetSpec("sice_grad", Task.LLIE, _TT, paired=True),
    DatasetSpec("sice_mix", Task.LLIE, _TT, paired=True),
    DatasetSpec("sice_mix_v2", Task.LLIE, _TT, paired=True),
    DatasetSpec("sid_sony", Task.LLIE, _TT, paired=True),
    DatasetSpec("fivek_init", Task.RETOUCH, _TR, dirs=("fivek_init",), paired=False),
    DatasetSpec("fivek_a", Task.RETOUCH, _TT, paired=True),
    DatasetSpec("fivek_b", Task.RETOUCH, _TT, paired=True),
    DatasetSpec("fivek_c", Task.RETOUCH, _TT, paired=True),
    DatasetSpec("fivek_d", Task.RETOUCH, _TT, paired=True),
    # the reference's neurop_re_fivek_dark.py config names "fivek_dark"
    # without registering it (fivek.py registers init/a-e only); enhax
    # registers the darkened-FiveK variant so the shipped recipe resolves
    DatasetSpec("fivek_dark", Task.RETOUCH, _TT, paired=True),
    DatasetSpec("fivek_e", Task.RETOUCH, _TT, paired=True),
    DatasetSpec("dicm", Task.LLIE, _T, paired=False),
    DatasetSpec("lime", Task.LLIE, _T, paired=False),
    DatasetSpec("mef", Task.LLIE, _T, paired=False),
    DatasetSpec("npe", Task.LLIE, _T, paired=False),
    DatasetSpec("vv", Task.LLIE, _T, paired=False),
    DatasetSpec("fusion", Task.LLIE, _T, paired=False),
    DatasetSpec("darkface", Task.LLIE, _TT, paired=False),
    DatasetSpec("exdark", Task.LLIE, _TT, paired=False),
    DatasetSpec("ledlight", Task.LES, _TT, paired=True),
    DatasetSpec("lighteffect", Task.LES, _TT, paired=False),
    DatasetSpec("nightcity", Task.NIGHTTIME, _TT, paired=True),
    DatasetSpec("loli_street", Task.LLIE, _TT, paired=True),
    DatasetSpec("loli_street_val", Task.LLIE, _T, dirs=("loli_street/val/image",), paired=True),
    DatasetSpec("loli_street_test", Task.LLIE, _T, dirs=("loli_street/test/image",), paired=True),
    DatasetSpec("ulol", Task.LLIE, _TT, paired=False, dirs=(
        "dicm/test/image", "fusion/test/image", "lime/test/image",
        "lol_v1/{split}/image", "lol_v2_real/{split}/image",
        "lol_v2_synthetic/{split}/image", "mef/test/image", "npe/test/image",
        "sice_mix/{split}/image", "sice_mix_v2/{split}/image", "vv/test/image")),
    # --- dehaze (reside.py, densehaze.py, ihaze.py, ohaze.py, nhhaze.py,
    # satehaze1k.py) ----------------------------------------------------------
    DatasetSpec("reside_hsts_real", Task.DEHAZE, _T, paired=False),
    DatasetSpec("reside_hsts_syn", Task.DEHAZE, _T, paired=True),
    DatasetSpec("reside_its", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("reside_its_v2", Task.DEHAZE, _TR, paired=True),
    DatasetSpec("reside_ots", Task.DEHAZE, _TR, paired=True),
    DatasetSpec("reside_rtts", Task.DEHAZE, _T, paired=False),
    DatasetSpec("reside_sots_indoor", Task.DEHAZE, _T, paired=True),
    DatasetSpec("reside_sots_outdoor", Task.DEHAZE, _T, paired=True),
    DatasetSpec("reside_uhi", Task.DEHAZE, _T, paired=False),
    DatasetSpec("densehaze", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("ihaze", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("ohaze", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("nhhaze", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("satehaze1k", Task.DEHAZE, _TT, paired=True, dirs=(
        "satehaze1k_thin/{split}/image", "satehaze1k_moderate/{split}/image",
        "satehaze1k_thick/{split}/image")),
    DatasetSpec("satehaze1k_thin", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("satehaze1k_moderate", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("satehaze1k_thick", Task.DEHAZE, _TT, paired=True),
    # --- derain (rain100.py, rain12.py, rain800.py, rain1200.py, rain1400.py,
    # rain2800.py, rain13k.py, gtrain.py) --------------------------------------
    DatasetSpec("rain100", Task.DERAIN, _TT, paired=True, has_test_annotations=True),
    DatasetSpec("rain100h", Task.DERAIN, _TT, paired=True, has_test_annotations=True),
    DatasetSpec("rain100l", Task.DERAIN, _TT, paired=True, has_test_annotations=True),
    DatasetSpec("rain12", Task.DERAIN, _TR, paired=True),
    DatasetSpec("rain800", Task.DERAIN, _TT, paired=True),
    DatasetSpec("rain1200", Task.DERAIN, _TT, paired=True),
    DatasetSpec("rain1400", Task.DERAIN, _TT, paired=True),
    DatasetSpec("rain2800", Task.DERAIN, _TT, paired=True),
    DatasetSpec("rain13k", Task.DERAIN, _TT, paired=True),
    DatasetSpec("gtrain", Task.DERAIN, _TT, paired=True),
    # --- desnow (snow100k.py, gtsnow.py, kitti_snow.py) -----------------------
    DatasetSpec("snow100k", Task.DESNOW, _TT, paired=True, dirs=("snow100k/{split}/lq",)),
    DatasetSpec("snow100k_s", Task.DESNOW, _TT, paired=True),
    DatasetSpec("snow100k_m", Task.DESNOW, _TT, paired=True),
    DatasetSpec("snow100k_l", Task.DESNOW, _TT, paired=True),
    DatasetSpec("gtsnow", Task.DESNOW, _TT, paired=True),
    DatasetSpec("kitti_snow", Task.DESNOW, _TT, paired=True),
    DatasetSpec("kitti_snow_s", Task.DESNOW, _TT, paired=True),
    DatasetSpec("kitti_snow_m", Task.DESNOW, _TT, paired=True),
    DatasetSpec("kitti_snow_l", Task.DESNOW, _TT, paired=True),
    # --- flare / nighttime (flare7k.py, flarereal800.py, mipi.py) -------------
    DatasetSpec("flare7k++_real", Task.NIGHTTIME, _TT, paired=True),
    DatasetSpec("flare7k++_syn", Task.NIGHTTIME, _TT, paired=True),
    DatasetSpec("flarereal800", Task.NIGHTTIME, _TT, paired=True),
    DatasetSpec("mipi24_flare", Task.NIGHTTIME, _TT, paired=True),
    # --- cityscapes family (cityscapes/) --------------------------------------
    DatasetSpec("cityscapes", Task.SEGMENT, _TT, paired=False),
    DatasetSpec("cityscapes_rain", Task.DERAIN, _TT, paired=True),
    DatasetSpec("cityscapes_foggy", Task.DEHAZE, _TT, paired=True),
    DatasetSpec("cityscapes_snow", Task.DESNOW, _TT, paired=True),
    DatasetSpec("cityscapes_snow_s", Task.DESNOW, _TT, paired=True),
    DatasetSpec("cityscapes_snow_m", Task.DESNOW, _TT, paired=True),
    DatasetSpec("cityscapes_snow_l", Task.DESNOW, _TT, paired=True),
    # --- deblur/denoise benchmark sets used by HINet/NAFNet/Restormer
    # (BASELINE.md config 3; reference exercises them via vendored repos) ----
    DatasetSpec("gopro", Task.DEBLUR, _TT, paired=True, has_test_annotations=True),
    DatasetSpec("sidd", Task.DENOISE, _TT, paired=True, has_test_annotations=True),
    DatasetSpec("reds", Task.DEBLUR, _TT, paired=True),
    # --- detection-ish (coco/) ------------------------------------------------
    DatasetSpec("coco", Task.DETECT, _TT, paired=False),
]


def _make_dataset_class(spec: DatasetSpec):
    attrs = {"image": ImageAnnotation}
    if spec.paired:
        attrs["ref_image"] = ImageAnnotation
    if spec.depth:
        attrs["depth"] = DepthMapAnnotation
    dirs = spec.dirs or (f"{spec.name}/{{split}}/image",)

    class _Spec(MultimodalDataset):
        tasks = (spec.task,)
        splits = spec.splits
        datapoint_attrs = DatapointAttributes(attrs)
        has_test_annotations = spec.has_test_annotations
        _dirs = dirs
        _paired = spec.paired
        _depth = spec.depth

        def get_data(self):
            images = []
            for pattern in self._dirs:
                d = Path(self.root) / pattern.format(split=self.split.value)
                if d.is_dir():
                    images.extend(ImageAnnotation(p) for p in image_files(d))
            self.datapoints["image"] = images
            if self._paired:
                self.derive_ref_images()
            if self._depth:
                self.derive_depth()

        def filter_data(self):
            # a paired dataset needs its ref for training, and for a test
            # split where the dataset has test annotations
            if self._paired and (self.split == Split.TRAIN or self.has_test_annotations):
                super().filter_data()

    _Spec.__name__ = _Spec.__qualname__ = f"Dataset_{spec.name}"
    _Spec.__doc__ = f"{spec.name} ({spec.task.value}). Layout: root/" + ", root/".join(dirs)
    return _Spec


def _make_datamodule_class(spec: DatasetSpec, ds_cls):
    class _DM(DataModule):
        tasks = (spec.task,)
        dataset_cls = ds_cls
        dataset_splits = spec.splits

    _DM.__name__ = _DM.__qualname__ = f"DataModule_{spec.name}"
    return _DM


for _spec in _SPECS:
    _ds = _make_dataset_class(_spec)
    DATASETS.register(name=_spec.name, obj=_ds)
    DATAMODULES.register(name=_spec.name, obj=_make_datamodule_class(_spec, _ds))
