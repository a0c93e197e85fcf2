"""State carried across from the reference package.

The aligner has no weights. Its state is the shard text
(``PackedReference``), the FM index (``FMIndex``) and the scoring and
seeding parameters; the pipeline adds the taxonomy (``TaxDB``). Each
package defines its own classes for all of them, so the reference's
objects are mapped field by field, the numpy arrays shared as they are. Nothing here imports ``megapath_tpu``: any
object with the reference's fields will do.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import torch

from megapath_tpu_torch.align.engine import AlignEngine
from megapath_tpu_torch.align.params import AlignParams, MmpParams
from megapath_tpu_torch.index.fm import FMIndex
from megapath_tpu_torch.index.pack import PackedReference
from megapath_tpu_torch.taxonomy.taxdb import TaxDB

# every table a TaxDB holds after read_nodes/read_names/read_acc2tid
_TAXDB_FIELDS = ("parent", "rank_code", "is_species", "is_superkingdom",
                 "rank", "names", "acc2tid")


def align_params_from_reference(p) -> Union[AlignParams, MmpParams]:
    """Map a reference ``AlignParams`` (or ``MmpParams``) -- any dataclass
    with the same fields -- to the port's, ``mmp`` and ``extra_rounds``
    included. Raises TypeError on a field the port does not have."""
    d = dataclasses.asdict(p)
    if "mmp" not in d:
        return MmpParams(**d)
    d["mmp"] = MmpParams(**d["mmp"])
    d["extra_rounds"] = tuple(MmpParams(**m) for m in d["extra_rounds"])
    return AlignParams(**d)


def _same_fields(cls, obj):
    return cls(**{f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)})


def index_from_reference(ref, fm) -> Tuple[PackedReference, FMIndex]:
    """The reference's ``PackedReference`` and ``FMIndex`` as the port's;
    the arrays are shared, not copied."""
    return _same_fields(PackedReference, ref), _same_fields(FMIndex, fm)


def engine_from_reference(
    ref, fm, params, device: torch.device, device_seeding: bool = False
) -> AlignEngine:
    """The port's engine over the reference's shard and index, with the
    shard text (and, on device seeding, the FM tables) put on ``device``
    once."""
    if not isinstance(params, AlignParams):
        params = align_params_from_reference(params)
    ref, fm = index_from_reference(ref, fm)
    return AlignEngine(ref, fm, params, device=device, device_seeding=device_seeding)


def taxdb_from_reference(db) -> TaxDB:
    """The reference's ``TaxDB`` as the port's; its tables (arrays and
    dicts) are shared, not copied."""
    out = TaxDB(size=1)
    for name in _TAXDB_FIELDS:
        setattr(out, name, getattr(db, name))
    return out
