"""Raw-dataset -> WAI conversion framework of the port.

Counterpart of ``mapanything_tpu/data_processing/conversion/__init__.py``.

Parity: ``data_processing/wai_processing/scripts/conversion/*.py`` (15
imperative per-dataset scripts) + ``utils/wrapper.py`` (the scene loop) +
``utils/state.py`` (processing state). Re-designed declaratively: each
dataset is a :class:`~.core.DatasetAdapter` that yields
:class:`~.core.RawFrame` records; one shared :class:`~.core.SceneWriter`
does all WAI writing (images, EXR depth, scene_meta.json), and one
:func:`~.core.convert_scenes` loop handles state tracking, overwrite,
resume and error capture for every dataset.
"""

from mapanything_tpu_torch.data_processing.conversion.core import (  # noqa: F401
    DatasetAdapter,
    RawFrame,
    SceneWriter,
    convert_scenes,
    get_processing_state,
    set_processing_state,
)
from mapanything_tpu_torch.data_processing.conversion.adapters import (  # noqa: F401
    ADAPTERS,
    get_adapter,
)
