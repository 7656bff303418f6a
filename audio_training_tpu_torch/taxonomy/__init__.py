"""Label taxonomy (a copy of ``audio_training_tpu/taxonomy``): the eBird
maps, the ontology and the run's label space."""

from audio_training_tpu_torch.taxonomy.ebird import (
    get_all_birds,
    get_ebird_id,
    get_ebird_ids_to_labels,
    get_label_to_ebird_map,
)
from audio_training_tpu_torch.taxonomy.ontology import Ontology, load_ontology
from audio_training_tpu_torch.taxonomy.labels import (
    LabelSpace,
    admit_labels_by_count,
    get_excluded_labels,
    get_remappings,
)

__all__ = [
    "Ontology",
    "LabelSpace",
    "load_ontology",
    "get_all_birds",
    "get_label_to_ebird_map",
    "get_ebird_id",
    "get_ebird_ids_to_labels",
    "get_excluded_labels",
    "get_remappings",
    "admit_labels_by_count",
]
