"""Shared data models and schema types (leaf package, no device deps).

Parity reference: models/ package of the reference (models/README.md).
"""

from semadb_tpu_torch.models import constants  # noqa: F401
from semadb_tpu_torch.models.collection import Collection, UserPlan  # noqa: F401
from semadb_tpu_torch.models.errors import (  # noqa: F401
    ExistsError,
    NotFoundError,
    QuotaReachedError,
    SemaDBError,
    ShardUnavailableError,
    TimeoutError_,
    ValidationError,
)
from semadb_tpu_torch.models.point import (  # noqa: F401
    Point,
    PointAsMap,
    SearchResult,
    access_nested,
    decode_point_data,
    encode_point_data,
    extract_id_field,
    result_doc,
)
from semadb_tpu_torch.models.quantizer import (  # noqa: F401
    BinaryQuantizerParams,
    ProductQuantizerParams,
    Quantizer,
)
from semadb_tpu_torch.models.query import (  # noqa: F401
    FloatOptions,
    IntegerOptions,
    Query,
    SearchRequest,
    SortOption,
    StringArrayOptions,
    StringOptions,
    TextOptions,
    VectorFlatOptions,
    VectorVamanaOptions,
)
from semadb_tpu_torch.models.schema import (  # noqa: F401
    IndexSchema,
    IndexSchemaValue,
    StringParams,
    TextParams,
    VectorFlatParams,
    VectorVamanaParams,
)
