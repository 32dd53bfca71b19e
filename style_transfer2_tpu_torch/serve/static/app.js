/* Style Transfer frontend — vanilla JS (no jQuery).
 *
 * Protocol (same as the reference):
 *   outbound WS: applyParams, pause, reset, restartWorker, start
 *   inbound WS: iterateInfo, newParams, newSize, state, thumbnails, workerReady
 *   images: POST /upload {size, slot, data(base64 URL)}; poll GET /output.
 */
"use strict";

let ws = null;
let isStart = true;
const UPDATE_EVERY = 250; // ms between output image refreshes

const $ = (id) => document.getElementById(id);

function wsSend(obj) {
    if (ws && ws.readyState === WebSocket.OPEN) {
        ws.send(JSON.stringify(obj));
    }
}

function applyParams() {
    wsSend({type: "applyParams", params: $("params").value});
}

function resetImage() {
    wsSend({type: "reset"});
}

function startPause() {
    if (isStart) {
        $("start").textContent = "Pause";
        isStart = false;
        wsSend({type: "start"});
    } else {
        $("start").textContent = "Start";
        isStart = true;
        wsSend({type: "pause"});
    }
}

function refreshImage() {
    $("output-image").src = "/output?" + Date.now();
}

function enforceSize() {
    const box = $("resize-to");
    const maxSize = parseInt(box.max, 10);
    let size = parseInt(box.value, 10);
    if (size > maxSize) { size = maxSize; box.value = size; }
    return size;
}

function setWithDataURL(url, elem) {
    const img = new Image();
    img.onload = () => {
        img.className = "replace";
        const scale = elem.clientWidth / Math.max(img.naturalWidth,
                                                  img.naturalHeight);
        img.width = img.naturalWidth * scale;
        img.height = img.naturalHeight * scale;
        const old = elem.querySelector(".replace");
        if (old) { old.replaceWith(img); } else { elem.appendChild(img); }
    };
    img.src = url;
}

function uploadFile(files, elem, slot) {
    if (!files || !files.length) { return; }
    if ($("reset-image").checked) { resetImage(); }
    const reader = new FileReader();
    reader.onload = (e) => {
        const data = e.target.result;
        if (elem) { setWithDataURL(data, elem); }
        const body = new URLSearchParams({
            size: enforceSize(), slot: slot, data: data});
        fetch("/upload", {method: "POST", body: body});
    };
    reader.readAsDataURL(files[0]);
}

function makeDropZone(elem, slot) {
    const stop = (e) => { e.stopPropagation(); e.preventDefault(); };
    elem.ondragenter = stop;
    elem.ondragover = stop;
    elem.ondrop = (e) => {
        stop(e);
        elem.classList.add("drop-flash");
        setTimeout(() => elem.classList.remove("drop-flash"), 250);
        uploadFile(e.dataTransfer.files, elem, slot);
    };
}

function handleMessage(msg) {
    switch (msg.type) {
        case "iterateInfo": {
            $("iterate-stats").style.display = "";
            $("iterate").textContent = msg.i;
            $("step-size").textContent = msg.stepSize.toPrecision(3);
            $("its-per-s").textContent = msg.itsPerS.toPrecision(3);
            let traceStr = "";
            for (const key in msg.trace) {
                traceStr += key + ": " + Number(msg.trace[key]).toPrecision(4)
                    + "<br>";
            }
            $("trace-placeholder").innerHTML = traceStr;
            break;
        }
        case "newParams":
            $("params").value = msg.params;
            $("params-error").textContent = msg.errorString || "";
            break;
        case "newSize":
            $("resize-to").value = Math.max(msg.width, msg.height);
            $("output-image").width = msg.width;
            $("output-image").height = msg.height;
            break;
        case "state":
            if (msg.running) {
                $("start").textContent = "Pause";
                isStart = false;
            } else {
                $("start").textContent = "Start";
                isStart = true;
            }
            break;
        case "thumbnails":
            if (msg.content) { setWithDataURL(msg.content, $("content-drop")); }
            if (msg.style) { setWithDataURL(msg.style, $("style-drop")); }
            break;
        case "workerReady":
            $("pre-start-message").style.display = "none";
            document.querySelectorAll("button").forEach(
                (b) => b.removeAttribute("disabled"));
            break;
    }
}

function wsConnect() {
    const proto = location.protocol === "https:" ? "wss://" : "ws://";
    ws = new WebSocket(proto + location.host + "/websocket");
    ws.onopen = refreshImage;
    ws.onmessage = (e) => handleMessage(JSON.parse(e.data));
    ws.onclose = () => setTimeout(wsConnect, 1000);
}

document.addEventListener("DOMContentLoaded", () => {
    const stop = (e) => { e.stopPropagation(); e.preventDefault(); };
    document.body.ondragenter = stop;
    document.body.ondragover = stop;
    document.body.ondrop = stop;

    makeDropZone($("content-drop"), "content");
    makeDropZone($("style-drop"), "style");
    makeDropZone($("output-image"), "input");

    $("content-input").onchange = function () {
        uploadFile(this.files, $("content-drop"), "content");
    };
    $("style-input").onchange = function () {
        uploadFile(this.files, $("style-drop"), "style");
    };

    $("start").onclick = startPause;
    $("restart-worker").onclick = () => wsSend({type: "restartWorker"});
    $("apply-params").onclick = applyParams;
    $("apply-and-reset").onclick = () => { applyParams(); resetImage(); };
    $("show-trace").onclick = (e) => {
        e.preventDefault();
        $("trace").style.display = "";
    };
    $("resize-to").oninput = enforceSize;

    $("output-image").addEventListener("load", () => {
        setTimeout(refreshImage, UPDATE_EVERY);
    });
    $("output-image").addEventListener("error", () => {
        setTimeout(refreshImage, 4 * UPDATE_EVERY);
    });
    refreshImage();
    wsConnect();
});
