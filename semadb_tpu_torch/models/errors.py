"""Sentinel errors shared across layers.

Parity reference: cluster/errors.go (ErrExists, ErrTimeout, ErrNotFound,
ErrShardUnavailable, ErrQuotaReached) plus validation errors.
"""


class SemaDBError(Exception):
    """Base class for all framework errors."""


class ValidationError(SemaDBError, ValueError):
    """Request or schema validation failed."""


class ExistsError(SemaDBError):
    """Entity already exists (reference: cluster/errors.go ErrExists)."""


class NotFoundError(SemaDBError):
    """Entity not found (reference: cluster/errors.go ErrNotFound)."""


class TimeoutError_(SemaDBError):
    """Operation timed out (reference: cluster/errors.go ErrTimeout)."""


class ShardUnavailableError(SemaDBError):
    """Shard could not be reached/loaded (cluster/errors.go)."""


class QuotaReachedError(SemaDBError):
    """User plan quota exceeded (cluster/errors.go ErrQuotaReached)."""
