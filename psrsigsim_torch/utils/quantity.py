"""Lightweight unit system for the config boundary.

The reference attaches ``astropy.units.Quantity`` to every physical parameter
via ``make_quant`` (reference: psrsigsim/utils/utils.py:310-340) and relies on
unit decomposition in shape arithmetic, e.g.
``int((signal.samprate * self.period).decompose())``
(psrsigsim/pulsar/pulsar.py:124).  astropy is not available in this
environment, and — more importantly — units must never leak into device
kernels.  This module provides a minimal, dependency-free quantity layer used
ONLY at the config boundary: inputs are parsed into :class:`Quantity`,
converted to canonical floats (MHz / s / Jy / K), and plain tensors flow into
the device code.

Canonical base units for ``decompose()``: s (time), m (length), K
(temperature), Jy (flux density, treated as an opaque dimension), rad (angle).
"""

from __future__ import annotations

import numbers

import numpy as np

__all__ = ["Unit", "Quantity", "make_quant", "UnitConversionError"]


class UnitConversionError(ValueError):
    """Raised when converting between incompatible units."""


# Dimension exponent vector: (time, length, temperature, flux, angle)
_NDIM = 5
_DIMLESS = (0, 0, 0, 0, 0)

# name -> (scale to canonical base, dims)
_REGISTRY = {
    # time
    "s": (1.0, (1, 0, 0, 0, 0)),
    "ms": (1e-3, (1, 0, 0, 0, 0)),
    "us": (1e-6, (1, 0, 0, 0, 0)),
    "ns": (1e-9, (1, 0, 0, 0, 0)),
    "min": (60.0, (1, 0, 0, 0, 0)),
    "hr": (3600.0, (1, 0, 0, 0, 0)),
    "h": (3600.0, (1, 0, 0, 0, 0)),
    "day": (86400.0, (1, 0, 0, 0, 0)),
    "yr": (86400.0 * 365.25, (1, 0, 0, 0, 0)),
    # frequency = 1/time
    "Hz": (1.0, (-1, 0, 0, 0, 0)),
    "kHz": (1e3, (-1, 0, 0, 0, 0)),
    "MHz": (1e6, (-1, 0, 0, 0, 0)),
    "GHz": (1e9, (-1, 0, 0, 0, 0)),
    # length
    "m": (1.0, (0, 1, 0, 0, 0)),
    "cm": (1e-2, (0, 1, 0, 0, 0)),
    "km": (1e3, (0, 1, 0, 0, 0)),
    "pc": (3.0856775814913673e16, (0, 1, 0, 0, 0)),
    # temperature
    "K": (1.0, (0, 0, 1, 0, 0)),
    # flux density (opaque radio-astronomy dimension)
    "Jy": (1.0, (0, 0, 0, 1, 0)),
    "mJy": (1e-3, (0, 0, 0, 1, 0)),
    "uJy": (1e-6, (0, 0, 0, 1, 0)),
    # angle
    "rad": (1.0, (0, 0, 0, 0, 1)),
    "deg": (np.pi / 180.0, (0, 0, 0, 0, 1)),
    # dimensionless
    "": (1.0, _DIMLESS),
    "1": (1.0, _DIMLESS),
    "dimensionless": (1.0, _DIMLESS),
}

_BASE_NAMES = {
    (1, 0, 0, 0, 0): "s",
    (0, 1, 0, 0, 0): "m",
    (0, 0, 1, 0, 0): "K",
    (0, 0, 0, 1, 0): "Jy",
    (0, 0, 0, 0, 1): "rad",
}


def _parse_unit_expr(expr):
    """Parse a unit expression like ``'Jy*m^2/K'`` or ``'pc/cm^3'``.

    Returns (scale, dims). Supports '*' and '/' separators and '^'/'**'
    integer powers — the full set of forms the reference passes to
    ``make_quant`` (e.g. 'pc/cm^3' at psrsigsim/ism/ism.py:28, 'Jy*m^2/K' at
    psrsigsim/telescope/telescope.py:12).
    """
    scale = 1.0
    dims = [0] * _NDIM
    expr = expr.replace("**", "^")
    # tokenize keeping the sign of each factor
    token = ""
    sign = 1
    tokens = []
    for ch in expr:
        if ch in "*/":
            tokens.append((token.strip(), sign))
            sign = 1 if ch == "*" else -1
            token = ""
        else:
            token += ch
    tokens.append((token.strip(), sign))

    for tok, sgn in tokens:
        if not tok:
            continue
        if "^" in tok:
            name, p = tok.split("^", 1)
            power = float(p)
            if power.is_integer():
                power = int(power)
        else:
            name, power = tok, 1
        name = name.strip()
        if name not in _REGISTRY:
            raise UnitConversionError(f"unknown unit {name!r} in {expr!r}")
        uscale, udims = _REGISTRY[name]
        scale *= uscale ** (sgn * power)
        for i in range(_NDIM):
            dims[i] += udims[i] * sgn * power
    return scale, tuple(dims)


class Unit:
    """A (possibly compound) physical unit: scale to base + dimension vector."""

    __slots__ = ("scale", "dims", "name")

    def __init__(self, name_or_scale, dims=None, name=None):
        if isinstance(name_or_scale, Unit):
            self.scale, self.dims, self.name = (
                name_or_scale.scale,
                name_or_scale.dims,
                name_or_scale.name,
            )
        elif isinstance(name_or_scale, str):
            self.scale, self.dims = _parse_unit_expr(name_or_scale)
            self.name = name_or_scale
        else:
            self.scale = float(name_or_scale)
            self.dims = tuple(dims)
            self.name = name if name is not None else self._auto_name()

    def _auto_name(self):
        if self.dims == _DIMLESS and self.scale == 1.0:
            return ""
        num, den = [], []
        for base_dims, base_name in _BASE_NAMES.items():
            axis = base_dims.index(1)
            p = self.dims[axis]
            if p > 0:
                num.append(base_name if p == 1 else f"{base_name}^{p}")
            elif p < 0:
                den.append(base_name if p == -1 else f"{base_name}^{-p}")
        s = "*".join(num) if num else "1"
        if den:
            s += "/" + "/".join(den)
        if self.scale != 1.0:
            s = f"{self.scale:g} {s}"
        return s

    @property
    def is_dimensionless(self):
        return self.dims == _DIMLESS

    def __eq__(self, other):
        other = Unit(other) if not isinstance(other, Unit) else other
        return self.scale == other.scale and self.dims == other.dims

    def __hash__(self):
        return hash((self.scale, self.dims))

    def __repr__(self):
        return f"Unit({self.name!r})"

    def __str__(self):
        return self.name

    def __mul__(self, other):
        if isinstance(other, Unit):
            return Unit(
                self.scale * other.scale,
                tuple(a + b for a, b in zip(self.dims, other.dims)),
                name=_join_names(self.name, other.name, "*"),
            )
        if isinstance(other, Quantity):
            return Quantity(other.value, other.unit * self)
        return Quantity(other, self)

    __rmul__ = __mul__

    def __truediv__(self, other):
        other = Unit(other) if isinstance(other, str) else other
        return Unit(
            self.scale / other.scale,
            tuple(a - b for a, b in zip(self.dims, other.dims)),
            name=_join_names(self.name, other.name, "/"),
        )

    def __pow__(self, p):
        return Unit(
            self.scale**p,
            tuple(d * p for d in self.dims),
            name=f"({self.name})^{p}" if self.name else "",
        )

    def to_scale(self, other):
        """Conversion factor self -> other; raises if dims differ."""
        other = Unit(other) if not isinstance(other, Unit) else other
        if self.dims != other.dims:
            raise UnitConversionError(
                f"cannot convert {self.name!r} to {other.name!r}"
            )
        return self.scale / other.scale


def _join_names(a, b, op):
    a = a or "1"
    b = b or "1"
    if op == "*":
        return f"{a}*{b}"
    return f"{a}/({b})" if ("*" in b or "/" in b) else f"{a}/{b}"


dimensionless = Unit(1.0, _DIMLESS, name="")


class Quantity:
    """A value (scalar or ndarray) with a :class:`Unit`.

    Mirrors the slice of ``astropy.units.Quantity`` behavior the reference
    exercises: arithmetic, ``.to()``, ``.value``, ``.decompose()``,
    comparisons, and a handful of numpy ufuncs (power/sqrt/abs/log).
    """

    __slots__ = ("value", "unit")

    def __init__(self, value, unit=dimensionless):
        if isinstance(value, Quantity):
            if unit is dimensionless:
                unit = value.unit
                value = value.value
            else:
                # convert (astropy semantics), never re-tag the raw value
                target = unit if isinstance(unit, Unit) else Unit(unit)
                value = value.value * value.unit.to_scale(target)
                unit = target
        self.value = np.asarray(value) if not np.isscalar(value) else value
        if isinstance(self.value, np.ndarray) and self.value.ndim == 0:
            self.value = self.value.item()
        self.unit = unit if isinstance(unit, Unit) else Unit(unit)

    # -- conversion ---------------------------------------------------------
    def to(self, unit):
        unit = Unit(unit) if not isinstance(unit, Unit) else unit
        return Quantity(self.value * self.unit.to_scale(unit), unit)

    def decompose(self):
        base_dims = self.unit.dims
        name = Unit(1.0, base_dims)._auto_name() if base_dims != _DIMLESS else ""
        return Quantity(self.value * self.unit.scale, Unit(1.0, base_dims, name=name))

    def si(self):
        return self.decompose()

    @property
    def base_value(self):
        """Plain float/ndarray in canonical base units (s, m, K, Jy, rad)."""
        return self.value * self.unit.scale

    # -- python numeric protocol -------------------------------------------
    def __float__(self):
        if not self.unit.is_dimensionless:
            raise UnitConversionError(
                f"cannot convert quantity with unit {self.unit} to float"
            )
        return float(self.value * self.unit.scale)

    def __int__(self):
        return int(self.__float__())

    def __len__(self):
        return len(self.value)

    def __getitem__(self, idx):
        return Quantity(self.value[idx], self.unit)

    def __array__(self, dtype=None, copy=None):
        arr = np.asarray(self.value)
        return arr.astype(dtype) if dtype is not None else arr

    def __iter__(self):
        for v in np.atleast_1d(self.value):
            yield Quantity(v, self.unit)

    # -- arithmetic ---------------------------------------------------------
    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value * other.value, self.unit * other.unit)
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit * other)
        return Quantity(self.value * other, self.unit)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value / other.value, self.unit / other.unit)
        if isinstance(other, Unit):
            return Quantity(self.value, self.unit / other)
        return Quantity(self.value / other, self.unit)

    def __rtruediv__(self, other):
        if isinstance(other, Quantity):  # pragma: no cover - handled by __truediv__
            return other / self
        return Quantity(other / self.value, dimensionless / self.unit)

    def __pow__(self, p):
        return Quantity(self.value**p, self.unit**p)

    def _coerced(self, other):
        """Return other's value expressed in self's unit."""
        if isinstance(other, Quantity):
            return other.value * other.unit.to_scale(self.unit)
        if self.unit.is_dimensionless:
            return np.asarray(other) / self.unit.scale if not np.isscalar(other) else other / self.unit.scale
        raise UnitConversionError(
            f"cannot combine dimensionless value with unit {self.unit}"
        )

    def __add__(self, other):
        return Quantity(self.value + self._coerced(other), self.unit)

    def __radd__(self, other):
        return self.__add__(other)

    def __sub__(self, other):
        return Quantity(self.value - self._coerced(other), self.unit)

    def __rsub__(self, other):
        return Quantity(self._coerced(other) - self.value, self.unit)

    def __neg__(self):
        return Quantity(-self.value, self.unit)

    def __abs__(self):
        return Quantity(abs(self.value), self.unit)

    # -- comparisons --------------------------------------------------------
    def _cmp_value(self, other):
        if isinstance(other, Quantity):
            return other.value * other.unit.to_scale(self.unit)
        return other  # compare raw numbers against .value (astropy would raise;
        # the reference only compares like-united quantities or raw zeros)

    def __eq__(self, other):
        if other is None:
            return False
        try:
            return self.value == self._cmp_value(other)
        except UnitConversionError:
            return False

    def __ne__(self, other):
        eq = self.__eq__(other)
        return ~eq if isinstance(eq, np.ndarray) else not eq

    def __lt__(self, other):
        return self.value < self._cmp_value(other)

    def __le__(self, other):
        return self.value <= self._cmp_value(other)

    def __gt__(self, other):
        return self.value > self._cmp_value(other)

    def __ge__(self, other):
        return self.value >= self._cmp_value(other)

    def __hash__(self):
        # consistent with __eq__: equal quantities in different units (1 ms
        # vs 0.001 s) hash equally, via base-unit value + dims
        return hash((np.asarray(self.base_value).tobytes(), self.unit.dims))

    # -- numpy ufunc interop -----------------------------------------------
    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        if method != "__call__":
            return NotImplemented
        if ufunc is np.power:
            base, p = inputs
            if isinstance(base, Quantity):
                return base**p
            return NotImplemented
        if ufunc in (np.sqrt,):
            (q,) = inputs
            return Quantity(np.sqrt(q.value), q.unit**0.5)
        if ufunc in (np.absolute, np.abs):
            (q,) = inputs
            return abs(q)
        if ufunc in (np.log, np.log10, np.log2, np.exp):
            (q,) = inputs
            if not q.unit.is_dimensionless:
                raise UnitConversionError(f"{ufunc.__name__} requires dimensionless input")
            return getattr(np, ufunc.__name__)(q.value * q.unit.scale)
        if ufunc is np.multiply:
            a, b = inputs
            return (a if isinstance(a, Quantity) else Quantity(a)) * b
        if ufunc in (np.divide, np.true_divide):
            a, b = inputs
            return (a if isinstance(a, Quantity) else Quantity(a)) / b
        if ufunc is np.add:
            a, b = inputs
            return (a if isinstance(a, Quantity) else Quantity(a)) + b
        if ufunc is np.subtract:
            a, b = inputs
            return (a if isinstance(a, Quantity) else Quantity(a)) - b
        return NotImplemented

    # -- misc ---------------------------------------------------------------
    @property
    def shape(self):
        return np.shape(self.value)

    @property
    def ndim(self):
        return np.ndim(self.value)

    def max(self):
        return Quantity(np.max(self.value), self.unit)

    def min(self):
        return Quantity(np.min(self.value), self.unit)

    def sum(self):
        return Quantity(np.sum(self.value), self.unit)

    def mean(self):
        return Quantity(np.mean(self.value), self.unit)

    def __repr__(self):
        return f"<Quantity {self.value} {self.unit.name}>"

    def __str__(self):
        return f"{self.value} {self.unit.name}".strip()


def make_quant(param, default_unit):
    """Initialize a parameter as a :class:`Quantity` (reference parity).

    Mirrors ``psrsigsim.utils.make_quant`` (reference:
    psrsigsim/utils/utils.py:310-340): if ``param`` already carries a unit it
    is validated for convertibility and returned unchanged; otherwise the
    default unit is attached.
    """
    unit = Unit(default_unit) if not isinstance(default_unit, Unit) else default_unit
    if isinstance(param, Quantity):
        if param.unit.dims != unit.dims:
            raise ValueError(
                f"Quantity {param} with incompatible unit {unit.name}"
            )
        return param
    if isinstance(param, (numbers.Number, np.ndarray, list, tuple)):
        return Quantity(np.asarray(param) if isinstance(param, (list, tuple)) else param, unit)
    raise TypeError(f"cannot make a Quantity from {type(param)}")
