"""Schema: declarative column typing for tables.

Mirrors the reference's class-based schemas (python/pathway/internals/
schema.py:1008): `class S(pw.Schema): a: int = pw.column_definition(...)`,
plus programmatic constructors `schema_from_types` / `schema_from_dict` /
`schema_from_pandas`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Iterator, Mapping

from . import dtype as dt


@dataclasses.dataclass(frozen=True)
class ColumnDefinition:
    dtype: dt.DType = dt.ANY
    primary_key: bool = False
    default_value: Any = ...
    name: str | None = None
    # OpenAPI documentation traits (reference: internals/schema.py
    # ColumnDefinition.description/example, surfaced by io/http/_server.py)
    description: str | None = None
    example: Any = None

    def has_default(self) -> bool:
        return self.default_value is not ...


def column_definition(
    *,
    primary_key: bool = False,
    default_value: Any = ...,
    dtype: Any = None,
    name: str | None = None,
    description: str | None = None,
    example: Any = None,
) -> Any:
    return ColumnDefinition(
        dtype=dt.wrap(dtype) if dtype is not None else dt.ANY,
        primary_key=primary_key,
        default_value=default_value,
        name=name,
        description=description,
        example=example,
    )


class SchemaMetaclass(type):
    __columns__: dict[str, ColumnDefinition]

    def __init__(cls, name, bases, namespace, append_only: bool | None = None, **kwargs):
        super().__init__(name, bases, namespace)
        columns: dict[str, ColumnDefinition] = {}
        for base in reversed(bases):
            columns.update(getattr(base, "__columns__", {}))
        annotations = namespace.get("__annotations__", {})
        for col_name, annotation in annotations.items():
            if col_name.startswith("__"):
                continue
            default = namespace.get(col_name, ...)
            if isinstance(default, ColumnDefinition):
                cd = dataclasses.replace(
                    default,
                    dtype=default.dtype if default.dtype != dt.ANY else dt.wrap(annotation),
                )
            else:
                cd = ColumnDefinition(dtype=dt.wrap(annotation), default_value=default)
            out_name = cd.name or col_name
            columns[out_name] = cd
        cls.__columns__ = columns
        cls.__append_only__ = bool(append_only) if append_only is not None else getattr(
            cls, "__append_only__", False
        )

    # -- mapping-ish API ---------------------------------------------------
    def column_names(cls) -> list[str]:
        return list(cls.__columns__.keys())

    def columns(cls) -> Mapping[str, ColumnDefinition]:
        return dict(cls.__columns__)

    def primary_key_columns(cls) -> list[str] | None:
        pk = [n for n, c in cls.__columns__.items() if c.primary_key]
        return pk or None

    def typehints(cls) -> dict[str, Any]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def dtypes(cls) -> dict[str, dt.DType]:
        return {n: c.dtype for n, c in cls.__columns__.items()}

    def keys(cls):
        return cls.__columns__.keys()

    def __getitem__(cls, name: str) -> ColumnDefinition:
        return cls.__columns__[name]

    def __iter__(cls) -> Iterator[str]:
        return iter(cls.__columns__)

    def __len__(cls) -> int:
        return len(cls.__columns__)

    def __or__(cls, other: "SchemaMetaclass") -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        cols.update(other.__columns__)
        return schema_from_columns(cols, name=f"{cls.__name__}|{other.__name__}")

    def with_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        cols = dict(cls.__columns__)
        for name, typ in kwargs.items():
            if name not in cols:
                raise ValueError(f"no column {name!r} in schema")
            cols[name] = dataclasses.replace(cols[name], dtype=dt.wrap(typ))
        return schema_from_columns(cols, name=cls.__name__)

    def without(cls, *names: str) -> "SchemaMetaclass":
        cols = {n: c for n, c in cls.__columns__.items() if n not in names}
        return schema_from_columns(cols, name=cls.__name__)

    def update_types(cls, **kwargs: Any) -> "SchemaMetaclass":
        return cls.with_types(**kwargs)

    def __repr__(cls) -> str:
        inner = ", ".join(f"{n}: {c.dtype!r}" for n, c in cls.__columns__.items())
        return f"<Schema {cls.__name__}({inner})>"


class Schema(metaclass=SchemaMetaclass):
    __columns__: ClassVar[dict[str, ColumnDefinition]] = {}
    __append_only__: ClassVar[bool] = False


def schema_from_columns(
    columns: Mapping[str, ColumnDefinition], name: str = "Schema"
) -> SchemaMetaclass:
    cls = SchemaMetaclass(name, (Schema,), {})
    cls.__columns__ = dict(columns)
    return cls


def schema_from_types(_name: str = "Schema", **kwargs: Any) -> SchemaMetaclass:
    return schema_from_columns(
        {n: ColumnDefinition(dtype=dt.wrap(t)) for n, t in kwargs.items()}, name=_name
    )


def schema_from_dict(
    columns: Mapping[str, Any], name: str = "Schema"
) -> SchemaMetaclass:
    out: dict[str, ColumnDefinition] = {}
    for n, spec in columns.items():
        if isinstance(spec, ColumnDefinition):
            out[n] = spec
        elif isinstance(spec, dict):
            out[n] = ColumnDefinition(
                dtype=dt.wrap(spec.get("dtype", Any)),
                primary_key=spec.get("primary_key", False),
                default_value=spec.get("default_value", ...),
            )
        else:
            out[n] = ColumnDefinition(dtype=dt.wrap(spec))
    return schema_from_columns(out, name=name)


def schema_from_pandas(
    df, *, id_from: list[str] | None = None, name: str = "PandasSchema"
) -> SchemaMetaclass:
    import numpy as np

    cols: dict[str, ColumnDefinition] = {}
    for col in df.columns:
        np_dt = df[col].dtype
        try:
            kind = np.dtype(np_dt).kind
        except TypeError:
            kind = getattr(np_dt, "kind", "O")  # pandas extension dtypes
        if kind in "iu":
            d = dt.INT
        elif kind == "f":
            d = dt.FLOAT
        elif kind == "b":
            d = dt.BOOL
        elif kind == "M":
            # tz-aware pandas datetimes are UTC-kind, naive otherwise
            d = (
                dt.DATE_TIME_UTC
                if getattr(np_dt, "tz", None) is not None
                else dt.DATE_TIME_NAIVE
            )
        else:
            inferred = {dt.dtype_of_value(v) for v in df[col] if v is not None}
            d = dt.lub(*inferred) if inferred else dt.ANY
        try:
            if df[col].isna().any():
                d = dt.optional(d)
        except (TypeError, ValueError):
            pass
        cols[str(col)] = ColumnDefinition(
            dtype=d, primary_key=bool(id_from and col in id_from)
        )
    return schema_from_columns(cols, name=name)


def is_schema(obj: Any) -> bool:
    return isinstance(obj, SchemaMetaclass)
